"""kernels_host_ms: the mean host ms a call in the kernels' host side: the spans
``molvoxel.prepare`` (transform table, checks, buffers, the preparation launch) and ``molvoxel.deposit``
(the autograd Function and the forward launch).  None where no kernel ran (the CPU's plain path).
"""

from portbench.program_spans import span_ms


def read(run):
    return span_ms(run, ("molvoxel.prepare", "molvoxel.deposit"))
