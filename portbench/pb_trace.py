"""Reading a ``torch.profiler`` trace of a steady part of the window: the
device-busy time (the union of the intervals in which an operation ran on
the device), each kernel's summed device time by name, the device
operations that took most time, and the longest idle gaps labelled with
what the host was doing (the harness's span and the innermost operator
running then).

The harness marks its own spans with ``record_function`` names starting
``pb.``; the traced window is the ``pb.window`` span.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "pb.window"


@dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: list                      # [[name, seconds], ...] top 10
    idle_gaps: list                       # [[label, seconds], ...] top 10
    _kernels: dict = field(default_factory=dict)   # name -> seconds

    def kernel_seconds(self, part: str) -> float:
        """Summed device time of the kernels whose name contains ``part``."""
        return sum(s for n, s in self._kernels.items() if part in n)


class Tracer:
    """``start()`` before the measured window and ``stop()`` after it
    (starting the profiler stalls the host for seconds, and stopping it
    for as long again while it parses what it recorded); ``begin()`` and
    ``end()`` mark the traced part inside the window; ``result() ->
    Trace`` reduces it. ``span(name)`` marks a host span (a no-op context
    when not tracing)."""

    def __init__(self):
        self._prof = None
        self._window = None
        self._done = None

    @property
    def active(self) -> bool:
        """The profiler runs (the host pays its cost)."""
        return self._prof is not None

    @property
    def recording(self) -> bool:
        """Inside the traced part."""
        return self._window is not None

    def start(self) -> None:
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()

    def begin(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def span(self, name: str):
        return record_function(name) if self._prof is not None else NULL_SPAN

    def end(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._window = None

    def stop(self) -> None:
        if self._window is not None:
            self.end()
        self._done, self._prof = self._prof, None
        self._done.stop()

    def result(self) -> Trace | None:
        return read_events(self._done.events()) if self._done else None


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _Null()


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_events(events) -> Trace:
    """Reduce the profiler's events (times in microseconds) to a Trace."""
    win = [e for e in events if e.name == WINDOW]
    if not win:
        raise RuntimeError("the trace holds no pb.window span")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith("pb."):
            if e.device_type != DeviceType.CUDA and e.name != WINDOW \
                    and b > a:
                host.append((a, b, e.name))
            continue      # the harness's spans are mirrored on the device
        if e.device_type == DeviceType.CUDA:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, e.name))
        elif b > a:
            host.append((a, b, e.name))
    busy = _union([(a, b) for a, b, _ in dev])
    kernels: dict = {}
    for a, b, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:10]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    return Trace(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=[[n[:160], s] for n, s in top],
        idle_gaps=[[_label(host, (a + b) / 2), (b - a) * 1e-6]
                   for a, b in gaps],
        _kernels=kernels)


def _label(host: list, t: float) -> str:
    """The harness span and the innermost operator covering time t."""
    covering = [(b - a, name) for a, b, name in host if a <= t <= b]
    spans = sorted(c for c in covering if c[1].startswith("pb."))
    ops = sorted(c for c in covering if not c[1].startswith("pb."))
    span = spans[0][1] if spans else "pb.loop"
    return f"{span} > {ops[0][1]}" if ops else span
