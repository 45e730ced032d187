"""call_ms_p95: the 95th percentile of every call or step of the window, from
the entry to its result ready, in ms (nearest rank).
"""

import math


def read(run):
    calls = sorted(run.window.calls_s)
    if not calls:
        return None
    return calls[max(0, math.ceil(0.95 * len(calls)) - 1)] * 1e3
