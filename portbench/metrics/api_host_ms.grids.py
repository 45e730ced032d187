"""api_host_ms: the mean host time inside the port's entry (forward_batch),
from the call to its return before the sync, in ms.
"""


def read(run):
    return None if run.timeline is None else run.timeline.mean_span_ms("api")
