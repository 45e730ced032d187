"""deposit_roofline_pct (store cells): the least time of the window's voxelization work (roofline.py) over
the device time of every kernel launched inside the cell's entry spans (``ENTRY_SPANS``), in percent;
``deposit_roofline_pct.grids``'s reading where the cell's end-to-end metric is ``grids_per_s``.
"""

from portbench.roofline import share_pct


def read(run):
    return share_pct(run)
