"""The benchmark's own spans around its calls into each layer of the port.

A span names what the host is doing: ``api`` (inside the port's entry),
``sync`` (waiting for the card), ``inputs`` (the caller building its next
call).  ``window`` spans the measured window.

In a traced run each span is a ``torch.profiler.record_function`` range, so
the device trace can tie every kernel to the span that launched it
(``timeline.py``); in an untraced run a span costs nothing.
"""

from __future__ import annotations

import contextlib

NAMES = ("api", "sync", "inputs")
WINDOW = "window"


class Spans:
    def __init__(self, traced: bool):
        self.traced = traced
        if traced:
            from torch.profiler import record_function

            self._record = record_function

    def __call__(self, name: str):
        return self._record(name) if self.traced else contextlib.nullcontext()
