"""deposit_roofline_pct: the least time of the window's voxelization work
(roofline.py) over the device time of every kernel launched inside the
port's entry spans, in percent.
"""

from portbench.roofline import share_pct


def read(run):
    return share_pct(run)
