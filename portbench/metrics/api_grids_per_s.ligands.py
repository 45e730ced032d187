"""api_grids_per_s: every grid returned in the traced window, over that
window: the closed loop's rate where the host's speed spreads it too widely
from run to run to hold it to a bound end to end.
"""


def read(run):
    return run.window.units / run.window.seconds
