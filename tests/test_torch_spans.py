"""The program's spans (``repro_torch.spans``) on a small sharded index on
the CPU.

- Under ``torch.profiler``, one compact ``run_batch`` records every span of
  the stages its path takes, each inside ``hippo.engine.batch``, as plain
  function events (no user annotation, so no device-side mirror).
- With no profiler, ``span()`` builds nothing and returns the shared no-op
  context, and a profiler started afterwards sees no ``hippo.`` event.
- Tickets, row ids and ``EngineStats`` are the same with and without the
  profiler.
- The write side: ``hippo.engine.write`` and ``hippo.engine.delete_rows``
  around the engine's calls, outside every batch; ``hippo.writer.insert``
  and ``hippo.writer.vacuum`` inside a batch's drain, and
  ``hippo.writer.patch`` inside the insert drain and the row delete.
  ``WriterStats.rows_deleted`` and ``patch_bytes`` count an insert drain's
  patch at the bytes of the pages it appended to, a range delete's at its
  dirty slabs' whole bytes and a row delete's at its ids' alone.
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
        # the drained insert queue and its slab patch (the index's build
        # left the view fresh)
        want |= {"hippo.engine.drain", "hippo.writer.insert",
                 "hippo.writer.patch"}
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


# -- the write side ------------------------------------------------------------

WRITE_PARENTS = {"hippo.engine.drain": {"hippo.engine.batch"},
                 "hippo.writer.insert": {"hippo.engine.drain"},
                 "hippo.writer.vacuum": {"hippo.engine.drain"},
                 "hippo.writer.patch": {"hippo.writer.insert",
                                        "hippo.engine.delete_rows"}}


def _writer_engine() -> QueryEngine:
    """A fresh 3-shard index (180 loaded pages: 97 in shard 0's slab, 83 in
    shard 1's) behind a between-batches writer draining two units a batch,
    its slab view fresh."""
    idx = ShardedHippoIndex.create(PagedTable.from_values(VALUES, 50),
                                   num_shards=3, resolution=400, device="cpu")
    eng = QueryEngine(idx, batch=16, drain_units=2)
    eng.submit(Predicate.between(0.0, 2600.0))
    eng.run_batch()
    assert not idx.table._dev_shard.pending
    return eng


def _inside(child, parent) -> bool:
    return (child.thread == parent.thread
            and parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


def test_the_write_side_spans_nest_as_stated():
    eng = _writer_engine()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for v in NEW_ROWS[:3]:
            eng.write(v)
        assert eng.delete_rows([5, 6, 7, 4000]) == 4
        eng.submit(Predicate.between(0.0, 2600.0))
        eng.run_batch()        # the insert queue, then shard 0's vacuum
    assert (eng.writer.stats.drains, eng.writer.stats.vacuums) == (2, 1)
    events = [e for e in prof.events() if e.name.startswith(spans.PREFIX)]
    names = [e.name for e in events]
    for name, n in (("hippo.engine.write", 3), ("hippo.engine.delete_rows", 1),
                    ("hippo.engine.drain", 1), ("hippo.writer.insert", 1),
                    ("hippo.writer.vacuum", 1), ("hippo.writer.patch", 2)):
        assert names.count(name) == n, name
    for e in events:
        assert not e.is_user_annotation, e.name
        parents = WRITE_PARENTS.get(e.name)
        if parents:
            assert any(p.name in parents and _inside(e, p) for p in events), \
                e.name
    batch = [e for e in events if e.name == "hippo.engine.batch"][0]
    assert not any(_inside(e, batch) for e in events
                   if e.name in ("hippo.engine.write",
                                 "hippo.engine.delete_rows"))
    # each patch inside the delete, or inside the insert drain
    patches = [e for e in events if e.name == "hippo.writer.patch"]
    owners = sorted(p.name for e in patches for p in events
                    if p.name in WRITE_PARENTS["hippo.writer.patch"]
                    and _inside(e, p))
    assert owners == ["hippo.engine.delete_rows", "hippo.writer.insert"]


def test_writer_counts_rows_deleted_and_patch_bytes():
    eng = _writer_engine()
    st = eng.writer.stats
    table = eng.index.table
    assert (st.rows_deleted, st.patch_bytes) == (0, 0)
    for v in NEW_ROWS:
        eng.write(v)
    eng.flush()
    # the drain patches only the page the 40 rows opened (the loaded pages
    # were full): 50 keys (4 B) and valid bytes (1 B)
    assert table.num_pages == 181
    assert st.patch_bytes == 1 * 50 * 5 == 250
    assert eng.delete_rows([0, 1, 2, 2, 9039]) == 4
    assert (st.rows_deleted, st.patch_bytes) == (4, 250 + 4 * 8)
    assert eng.delete_rows([0, 1]) == 0            # nothing left to patch
    assert (st.rows_deleted, st.patch_bytes) == (4, 282)
    # a range delete patches each slab it hit whole; shard 0 has 97 pages
    # and every page holds one of the 2,555 days' rows in range
    eng.flush()
    assert eng.delete(0.0, 2600.0) > 0
    assert st.patch_bytes == 282 + (97 + 84) * 250
    assert st.rows_deleted == 4
    # with no view to patch a row delete counts its rows and no bytes
    eng.flush()
    table._dev_shard = None
    eng.write(7.0)
    eng.flush()
    assert eng.delete_rows([9040]) == 1
    assert (st.rows_deleted, st.patch_bytes) == (5, 282 + 181 * 250)
