"""The read path's spans (``repro_torch.spans``) on a small sharded index on
the CPU.

- Under ``torch.profiler``, one compact ``run_batch`` records every span of
  the stages its path takes, each inside ``hippo.engine.batch``, as plain
  function events (no user annotation, so no device-side mirror).
- With no profiler, ``span()`` builds nothing and returns the shared no-op
  context, and a profiler started afterwards sees no ``hippo.`` event.
- Tickets, row ids and ``EngineStats`` are the same with and without the
  profiler.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import spans
from repro_torch.core.partition import ShardedHippoIndex
from repro_torch.core.predicate import Predicate
from repro_torch.runtime.engine import QueryEngine
from repro_torch.storage.table import PagedTable

VALUES = np.random.default_rng(21).integers(0, 2555, 9000).astype(np.float32)
NEW_ROWS = [float(v) for v in range(2556, 2596)]     # past the last day
STAGES = {"hippo.engine.batch", "hippo.engine.admit", "hippo.index.convert",
          "hippo.index.filter", "hippo.index.expand", "hippo.index.select",
          "hippo.index.inspect", "hippo.engine.readback",
          "hippo.engine.fallback", "hippo.engine.retire"}
CLOCKS = ("drain_us",)       # host clocks: no two runs read the same


def _engine(top_k: int, writer: str | None) -> QueryEngine:
    """A fresh 3-shard index and engine with 16 queries queued; the slab
    bucket starts at 4 pages, so the first batch falls back. ``writer``
    "overlay" leaves 40 rows staged (manual drains), "drain" has the batch
    drain them first."""
    idx = ShardedHippoIndex.create(PagedTable.from_values(VALUES, 50),
                                   num_shards=3, resolution=400, device="cpu")
    eng = QueryEngine(idx, batch=16, top_k=top_k, compact_bucket=4,
                      drain_policy="manual" if writer == "overlay"
                      else "between_batches")
    if writer:
        for v in NEW_ROWS:
            eng.write(v)
    rng = np.random.default_rng(5)
    for lo, w in zip(rng.integers(0, 2600, 16), [0, 9, 99, 400] * 4):
        eng.submit(Predicate.between(float(lo), float(lo + w)))
    return eng


def _batch(eng: QueryEngine):
    tickets = eng.run_batch()
    stats = {k: v for k, v in dataclasses.asdict(eng.stats).items()
             if k not in CLOCKS}
    return ([(t.qid, t.count, t.pages_inspected, t.entries_matched,
              None if t.row_ids is None else t.row_ids.tolist())
             for t in tickets], stats)


@pytest.mark.parametrize("writer", [None, "overlay", "drain"])
@pytest.mark.parametrize("top_k", [0, 32])
def test_one_batch_records_its_stages_inside_the_batch_span(top_k, writer):
    traced, plain = _engine(top_k, writer), _engine(top_k, writer)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = _batch(traced)
    assert got == _batch(plain)
    assert got[1]["compact_fallbacks"] > 0
    if writer == "overlay":
        assert traced.writer.staged_rows == len(NEW_ROWS)
    events = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    want = set(STAGES)
    if top_k:
        want.add("hippo.index.row_ids")
    if writer == "overlay":
        want.add("hippo.index.overlay")
    if writer == "drain":
        want.add("hippo.engine.drain")
    assert {e.name for e in events} == want
    batch = [e for e in events if e.name == "hippo.engine.batch"]
    assert len(batch) == 1
    b = batch[0].time_range
    for e in events:
        assert b.start <= e.time_range.start <= e.time_range.end <= b.end
        assert e.thread == batch[0].thread
        assert not e.is_user_annotation, e.name
    # the fallback re-runs the index stages inside its own span
    fb = [e for e in events if e.name == "hippo.engine.fallback"][0]
    assert any(e.name == "hippo.index.inspect"
               and fb.time_range.start <= e.time_range.start
               and e.time_range.end <= fb.time_range.end for e in events)


def test_a_record_function_is_a_user_annotation_and_a_span_is_not():
    """The profiler mirrors user annotations onto the device's timeline;
    the spans are recorded as plain function events instead."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("hippo.engine.batch"):
            with record_function("pb.batch"):
                torch.ones(4).sum()
    kinds = {e.name: e.is_user_annotation for e in prof.events()
             if e.name in ("hippo.engine.batch", "pb.batch")}
    assert kinds == {"hippo.engine.batch": False, "pb.batch": True}


def test_without_a_profiler_no_span_is_built(monkeypatch):
    built = []
    monkeypatch.setattr(spans, "_RecordFunctionFast",
                        lambda name: built.append(name))
    assert spans.span("hippo.engine.batch") is spans.NO_SPAN
    eng = _engine(32, "overlay")
    tickets = eng.run_batch()
    assert tickets and built == []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert not [e for e in prof.events()
                if e.name.startswith(spans.PREFIX)]
    with spans.NO_SPAN as s:
        assert s is spans.NO_SPAN
