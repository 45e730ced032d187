"""device_idle_pct (store cells): the share of the passes' own time in which no operation ran on the card, in
percent: the device's busy intervals intersected with the cell's entry spans (``ENTRY_SPANS``), over the
entry spans' total time inside the traced window.  The driver's readback and the deletion of each store lie
between the passes, outside those spans, so they do not count as idle.
"""


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    w0, w1 = tl.window
    entry = _merged((max(s, w0), min(e, w1)) for name in run.entry_spans for s, e, _ in tl.spans.get(name, ()))
    total = sum(e - s for s, e in entry)
    if total <= 0:
        return None
    busy, i = 0.0, 0
    for s, e in tl.busy:  # both lists sorted and disjoint
        while i < len(entry) and entry[i][1] <= s:
            i += 1
        j = i
        while j < len(entry) and entry[j][0] < e:
            busy += max(0.0, min(e, entry[j][1]) - max(s, entry[j][0]))
            j += 1
    return 100.0 * (1.0 - busy / total)
