"""device_idle_pct: the share of the traced window in which no operation ran on the card, in percent."""


def read(run):
    if run.timeline is None:
        return None
    return 100.0 * (1.0 - run.timeline.busy_s / run.timeline.window_s)
