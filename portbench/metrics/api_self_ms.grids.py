"""api_self_ms: the mean host ms a call of ``molvoxel.forward_batch`` that none of its child
spans covers: the entry's checks, radii and generator, and the return.
"""

from portbench.program_spans import ENTRY, span_ms


def read(run):
    return span_ms(run, (ENTRY,), "self_s")
