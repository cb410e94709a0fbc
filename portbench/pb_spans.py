"""Reading the program's own spans from a traced run.

``repro_torch.spans`` marks the read path's stages with host spans whose
names start ``hippo.`` (``hippo.engine.batch`` around each ``run_batch``,
``hippo.index.convert``, ``hippo.engine.readback`` and so on inside it),
recorded into the same ``torch.profiler`` trace as the kernels, so they
share the kernels' clock. Over the traced part (the ``pb.window`` span)
this reduces them to:

  per program span name: its host self time (the time in which it is the
      innermost program span), the device-idle time in which it is the
      innermost program span, and the host-blocking runtime calls that
      start inside it on its thread (``BLOCKING``);
  the same for the time outside every program span (the harness's loop);
  the number of ``hippo.engine.batch`` spans that closed in the traced
      part, the device-idle time inside them, and the blocking calls
      inside them;
  the longest idle gaps, each labelled with the harness span, the
      innermost program span and the innermost operator covering its
      middle.

A program without these spans (an earlier commit of the port) gives
nothing to read: the readers then return None.

The harness hands a metric reader the reduced ``pb_trace.Trace``, which
keeps no host event. Until ``Run`` carries the events, ``read(run)`` takes
them from the stopped profiler of the run's ``pb_trace.Tracer``, found
among the locals of the frames that called it (``pb_harness.run_cell``).
"""
from __future__ import annotations

import bisect
import json
import sys
from dataclasses import dataclass, field

from torch.autograd import DeviceType

import pb_trace

PREFIX = "hippo."
BATCH = "hippo.engine.batch"
HARNESS = "pb."
OUTSIDE = "(outside the program's spans)"
# Runtime calls that block the host until the device has caught up.
BLOCKING = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize", "cudaMemcpy"})


@dataclass
class Stages:
    window_s: float
    idle_s: float                     # device idle over the traced part
    batches: int                      # BATCH spans closed in it
    idle_in_batches_s: float          # idle inside BATCH spans
    syncs_in_batches: int             # blocking calls inside them
    host_self_s: dict = field(default_factory=dict)   # name -> s
    idle_by_span_s: dict = field(default_factory=dict)  # name -> s
    syncs_by_span: dict = field(default_factory=dict)   # name -> calls
    gaps: list = field(default_factory=list)   # [[label, s], ...] top 10

    def table(self) -> dict:
        """Per span name (and ``OUTSIDE``): host self ms, idle ms and
        blocking calls a batch, and the idle share of the traced part."""
        n = max(self.batches, 1)
        rows = {}
        for name in sorted(set(self.host_self_s) | set(self.idle_by_span_s)
                           | set(self.syncs_by_span)):
            rows[name] = {
                "host_self_ms": self.host_self_s.get(name, 0.0) * 1e3 / n,
                "idle_ms": self.idle_by_span_s.get(name, 0.0) * 1e3 / n,
                "idle_pct": self.idle_by_span_s.get(name, 0.0)
                / self.window_s * 100.0,
                "syncs": self.syncs_by_span.get(name, 0) / n}
        return {"batches": self.batches, "window_s": self.window_s,
                "device_idle_pct": self.idle_s / self.window_s * 100.0,
                "per_batch": rows, "idle_gaps": self.gaps}


def _segments(spans, w0: float, w1: float) -> list:
    """[w0, w1] cut where a program span starts or ends: [(a, b, name,
    thread)], name and thread those of the innermost span covering the
    piece (the latest started; None outside every span)."""
    pts = []
    for i, (a, b, name, thread) in enumerate(spans):
        a, b = max(a, w0), min(b, w1)
        if b > a:
            pts.append((a, 1, i))
            pts.append((b, 0, i))
    pts.sort()
    active: dict = {}
    out = []
    prev = w0

    def inner():
        if not active:
            return None, None
        i = max(active, key=lambda j: (spans[j][0], -spans[j][1]))
        return spans[i][2], spans[i][3]

    for t, starts, i in pts:
        if t > prev:
            out.append((prev, t) + inner())
            prev = t
        if starts:
            active[i] = True
        else:
            active.pop(i, None)
    if w1 > prev:
        out.append((prev, w1) + inner())
    return out


def _overlap(a_list, b_list) -> float:
    """Summed overlap of two sorted lists of disjoint intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a_list) and j < len(b_list):
        a0, a1 = a_list[i][0], a_list[i][1]
        b0, b1 = b_list[j][0], b_list[j][1]
        lo, hi = max(a0, b0), min(a1, b1)
        if hi > lo:
            tot += hi - lo
        if a1 <= b1:
            i += 1
        else:
            j += 1
    return tot


def read_stages(events) -> Stages | None:
    """Reduce a trace's events (``FunctionEvent``s, times in
    microseconds) to ``Stages``; None if the traced part holds no
    ``hippo.engine.batch`` span or ran nothing on the device."""
    win = [e for e in events if e.name == pb_trace.WINDOW
           and e.device_type != DeviceType.CUDA]
    if not win:
        return None
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, spans, harness, ops, syncs = [], [], [], [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        name = e.name
        if e.device_type == DeviceType.CUDA:
            # the device-side mirrors of host spans are no device work
            if not name.startswith((HARNESS, PREFIX)):
                a, b = max(a, w0), min(b, w1)
                if b > a:
                    dev.append((a, b))
        elif name.startswith(PREFIX):
            if b > a:
                spans.append((a, b, name, e.thread))
        elif name.startswith(HARNESS):
            if name != pb_trace.WINDOW and b > a:
                harness.append((a, b, name))
        else:
            if name in BLOCKING and w0 <= a <= w1:
                syncs.append((a, e.thread))
            if b > a:
                ops.append((a, b, name))
    batch = sorted((a, b, t) for a, b, name, t in spans
                   if name == BATCH and w0 <= b <= w1)
    if not batch or not dev:
        return None
    window = w1 - w0
    busy = pb_trace._union(dev)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    segs = _segments(spans, w0, w1)
    host_self, idle_by = {}, {}
    for a, b, name, _ in segs:
        key = name or OUTSIDE
        host_self[key] = host_self.get(key, 0.0) + (b - a)
    # idle pieces inside each segment
    j = 0
    for a, b, name, _ in segs:
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            lo, hi = max(a, idle[k][0]), min(b, idle[k][1])
            if hi > lo:
                key = name or OUTSIDE
                idle_by[key] = idle_by.get(key, 0.0) + (hi - lo)
            k += 1
    starts = [s[0] for s in segs]
    by_span = {}
    in_batches = 0
    b_starts = [a for a, _, _ in batch]
    for t, thread in syncs:
        s = segs[max(bisect.bisect_right(starts, t) - 1, 0)]
        key = s[2] if s[2] is not None and s[3] == thread else OUTSIDE
        by_span[key] = by_span.get(key, 0) + 1
        k = bisect.bisect_right(b_starts, t) - 1
        if k >= 0 and batch[k][0] <= t <= batch[k][1] \
                and batch[k][2] == thread:
            in_batches += 1
    in_batch_idle = _overlap(idle, pb_trace._union(
        [(a, b) for a, b, _ in batch]))
    gaps = sorted(idle, key=lambda g: g[1] - g[0], reverse=True)[:10]
    return Stages(
        window_s=window * 1e-6,
        idle_s=sum(b - a for a, b in idle) * 1e-6,
        batches=len(batch),
        idle_in_batches_s=in_batch_idle * 1e-6,
        syncs_in_batches=in_batches,
        host_self_s={k: v * 1e-6 for k, v in host_self.items()},
        idle_by_span_s={k: v * 1e-6 for k, v in idle_by.items()},
        syncs_by_span=by_span,
        gaps=[[_label(harness, segs, starts, ops, (a + b) / 2),
               (b - a) * 1e-6] for a, b in gaps])


def _innermost(intervals, t: float):
    covering = [(b - a, name) for a, b, name in intervals if a <= t <= b]
    return min(covering)[1] if covering else None


def _label(harness, segs, starts, ops, t: float) -> str:
    """The harness span, the innermost program span and the innermost
    operator covering time t."""
    parts = [_innermost(harness, t) or "pb.loop"]
    s = segs[max(bisect.bisect_right(starts, t) - 1, 0)]
    if s[2] is not None:
        parts.append(s[2])
    op = _innermost(ops, t)
    if op is not None:
        parts.append(op)
    return " > ".join(parts)


# -- the metric readers' side ---------------------------------------------

def _profiler_events(frame):
    """The events of the stopped profiler of the first ``pb_trace.Tracer``
    among the locals of ``frame`` and the frames that called it."""
    while frame is not None:
        for v in list(frame.f_locals.values()):
            if isinstance(v, pb_trace.Tracer) and v._done is not None:
                return v._done.events()
        frame = frame.f_back
    return None


def read(run, log=None) -> Stages | None:
    """The run's ``Stages`` (None for an untraced run, or one whose program
    has no spans); ``log`` takes the stage table as one ``stages: {...}``
    line."""
    if run.trace is None:
        return None
    events = _profiler_events(sys._getframe(1))
    st = read_stages(events) if events is not None else None
    if st is not None and log is not None:
        log("stages: " + json.dumps(st.table()))
    return st


def idle_in_engine(run):
    """Percent of the traced part in which the device idles inside a
    ``hippo.engine.batch`` span. Logs the stage table."""
    st = read(run, log=lambda s: print(s, flush=True))
    return st.idle_in_batches_s / st.window_s * 100.0 if st else None


def syncs_per_batch(run):
    """Host-blocking runtime calls inside ``hippo.engine.batch`` spans, a
    span."""
    st = read(run)
    return st.syncs_in_batches / st.batches if st else None
