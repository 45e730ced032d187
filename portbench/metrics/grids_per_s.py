"""grids_per_s: every grid returned in the window, over the whole window
(closed loop, each call ending with its grids ready).
"""


def read(run):
    return run.window.units / run.window.seconds
