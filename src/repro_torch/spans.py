"""Named spans at the stage boundaries of the read path and the write path,
recorded into a running ``torch.profiler`` trace.

``span(name)`` returns a profiler range while a torch profiler records
(``torch.autograd._profiler_enabled()``) and one shared no-op context
otherwise: no flag turns spans on; they appear exactly when someone
profiles (the benchmark's ``--trace 1``, or an operator's own
``torch.profiler`` around a serving loop), on the clock of that trace's
device events. Nesting on one thread gives each span its parent.

Each span is a host interval: around asynchronous device work it times the
enqueue, and the device side of that work is in the same trace.

The range is recorded as an ordinary function event, the way the profiler
records an operator, and not as a user annotation (``record_function``):
the profiler mirrors every user annotation onto the device's timeline for
the extent of the kernels launched inside it, and a reader of the device
trace would take that mirror for device work.
"""
from __future__ import annotations

import torch
from torch._C._profiler import _RecordFunctionFast

PREFIX = "hippo."


class _NoSpan:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str):
    """A context that records ``name`` (starting ``PREFIX``) as a host span
    while a profiler records, and does nothing otherwise."""
    if torch.autograd._profiler_enabled():
        return _RecordFunctionFast(name)
    return NO_SPAN
