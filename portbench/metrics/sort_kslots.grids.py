"""sort_kslots: the padded atom slots a call's preparation Morton-sorts, in units of 1,024 (Ki),
real atoms and padding alike; 0 where it does not sort (the port's counter
``molvoxel.sort_slots``, ops/deposit.py).
"""

from portbench.program_spans import counter_per_call


def read(run):
    n = counter_per_call(run, "molvoxel.sort_slots")
    return None if n is None else n / 1024
