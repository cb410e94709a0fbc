"""Port parity: the maintenance writer (``repro_torch.runtime.writer``) and
the writer-backed ``QueryEngine``.

One seeded stream of writes (in range and drifting past it), deletes,
batches and flushes goes through the JAX package (on the CPU) and the port
(``device="cpu"``) under each async drain policy. After every operation the
tickets (counts and row ids), ``EngineStats`` and ``WriterStats`` (wall
times and the port's own counters aside), every state field, the bounds epochs, the table and the
writer's queues must be equal. Then the refusals, each with the same
message and the same rollback, the slab view patched in place, and a crash
injected before a drain's swap.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import index as jix
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.runtime import faultinject as jfi
from repro.runtime.engine import QueryEngine as JEngine
from repro.runtime.writer import MaintenanceWriter as JWriter
from repro.storage.table import PagedTable as JTable
from repro_torch.core.hippo import HippoIndex as THippo
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.runtime import faultinject as tfi
from repro_torch.runtime.engine import QueryEngine as TEngine
from repro_torch.runtime.writer import MaintenanceWriter as TWriter
from repro_torch.runtime.writer import WriterStats
from repro_torch.storage.table import PagedTable as TTable

TIMES = {"drain_us", "last_drain_us", "total_drain_us"}   # wall clock
# the port's own WriterStats counters, after the reference's fields
PORT_ONLY = ("rows_deleted", "patch_bytes")
# the port's own EngineStats counters (the journal's), after the reference's
ENGINE_PORT_ONLY = ("journal_syncs", "journal_sync_us")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(ref, got, what):
    a, b = np.asarray(ref), _host(got)
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), what


def _assert_index_equal(j, t):
    for f in jix.HippoState._fields:
        _assert_equal(getattr(j.state.shards, f), getattr(t.state.shards, f), f)
    _assert_equal(j.state.summaries, t.state.summaries, "summaries")
    _assert_equal(j.bounds_epochs, t.bounds_epochs, "bounds_epochs")
    for f in ("keys", "valid", "dirty"):
        _assert_equal(getattr(j.table, f), getattr(t.table, f), f"table.{f}")
    for f in ("num_pages", "fill", "num_dirty", "capacity_pages"):
        assert getattr(j.table, f) == getattr(t.table, f), f
    assert dataclasses.asdict(j.counters) == dataclasses.asdict(t.counters)
    assert j.swap_in_flight is None and t.swap_in_flight is None


def _stats(stats) -> dict:
    return {k: v for k, v in dataclasses.asdict(stats).items()
            if k not in TIMES and k not in PORT_ONLY
            and k not in ENGINE_PORT_ONLY}


def _assert_writer_equal(jw, tw):
    assert _stats(jw.stats) == _stats(tw.stats)
    assert (jw.queue_depth, jw.staged_rows, jw.pending_units) == \
        (tw.queue_depth, tw.staged_rows, tw.pending_units)
    assert jw.queue_depths() == tw.queue_depths()
    assert jw.pending_shards() == tw.pending_shards()
    assert jw.pending_vacuum_shards() == tw.pending_vacuum_shards()
    assert jw.pending_resummarize_shards() == tw.pending_resummarize_shards()
    assert jw.dirty_checkpoint_shards() == tw.dirty_checkpoint_shards()
    for s, q in jw._queues.items():
        assert q.values == tw._queues[s].values and q.live == tw._queues[s].live
    _assert_equal(jw.drift.hits, tw.drift.hits, "hits")
    _assert_equal(jw.drift.sample(), tw.drift.sample(), "reservoir")
    assert (jw.drift.observed, jw.drift.out_of_range) == \
        (tw.drift.observed, tw.drift.out_of_range)


def _assert_engines_equal(je, te):
    assert _stats(je.stats) == _stats(te.stats)
    assert je._compact_bucket == te._compact_bucket
    assert je._auto_drain_suspended == te._auto_drain_suspended
    _assert_writer_equal(je.writer, te.writer)
    _assert_index_equal(je.index, te.index)


def _pair(values, shards=4, h=32, page_card=8, spare_pages=256, **kw):
    jt = JTable.from_values(np.asarray(values, np.float32), page_card,
                            spare_pages=spare_pages)
    tt = TTable.from_values(np.asarray(values, np.float32), page_card,
                            spare_pages=spare_pages)
    return (JSharded.create(jt, num_shards=shards, resolution=h,
                            density=0.25, **kw),
            TSharded.create(tt, num_shards=shards, resolution=h,
                            density=0.25, device="cpu", **kw))


def _preds(rng, n):
    spans = [(float(lo), float(lo + w)) for lo, w in
             zip(rng.uniform(0, 130, n), rng.choice([0.0, 3.0, 30.0], n))]
    spans += [(5.0, 1.0), (-np.inf, np.inf), (104.0, 118.0)]
    return [JPred.between(*s) for s in spans], [TPred.between(*s) for s in spans]


def _brute(table, lo, hi) -> int:
    live = table.valid[: table.num_pages]
    keys = table.keys[: table.num_pages]
    return int((live & (keys >= lo) & (keys <= hi)).sum())


def _run_equal(je, te, jp, tp, brute=True):
    """Both engines serve the same predicates: tickets equal, counts equal
    brute force over the table plus the live staged rows."""
    jt = [je.submit(p) for p in jp]
    tt = [te.submit(p) for p in tp]
    je.drain()
    te.drain()
    for a, b in zip(jt, tt):
        assert (a.count, a.pages_inspected, a.entries_matched) == \
            (b.count, b.pages_inspected, b.entries_matched), a.pred
        if a.row_ids is not None:
            assert np.array_equal(a.row_ids, b.row_ids), a.pred
    if brute:
        w = te.index.staging
        staged = (w.staged_counts([p.lo for p in tp], [p.hi for p in tp])
                  .sum(axis=1) if w is not None else 0)
        want = np.asarray([_brute(te.index.table, p.lo, p.hi) for p in tp])
        assert np.array_equal([b.count for b in tt], want + staged)
    return [b.count for b in tt]


# ---------------------------------------------------------------------------
# The interleaved stream, under every async policy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", [None, "between_batches", "on_depth",
                                    "manual"])
def test_interleaved_stream_equals_reference(policy):
    rng = np.random.default_rng(7)
    j, t = _pair(np.sort(rng.uniform(0, 100, 600)))
    kw = dict(batch=8, drain_policy=policy, drain_depth=24,
              drift_min_observed=16, top_k=6)
    je, te = JEngine(j, **kw), TEngine(t, **kw)
    assert te.drain_policy == (policy or "between_batches")
    assert te.drain_units == 1 and isinstance(te.writer, TWriter)
    # a routed dense engine on the same writer: the overlay of its path
    jr = JEngine(j, batch=8, mode="dense", drain_policy="manual",
                 writer=je.writer)
    tr = TEngine(t, batch=8, mode="dense", drain_policy="manual",
                 writer=te.writer)
    ops = rng.permutation(["write"] * 40 + ["drift"] * 30 + ["delete"] * 5
                          + ["batch"] * 12 + ["flush"] * 2)
    for step, op in enumerate(ops):
        if op == "write":
            v = float(rng.uniform(0, 100))
            je.write(v)
            te.write(v)
        elif op == "drift":
            v = float(rng.uniform(100, 130))
            je.write(v)
            te.write(v)
        elif op == "delete":
            lo = float(rng.uniform(0, 125))
            assert je.delete(lo, lo + 2.0) == te.delete(lo, lo + 2.0)
        elif op == "flush":
            assert je.flush() == te.flush()
        else:
            jp, tp = _preds(rng, 5)
            _run_equal(je, te, jp, tp)
            _run_equal(jr, tr, jp, tp)
        _assert_engines_equal(je, te)
    assert te.stats.resummarizes > 0 and te.stats.drains > 0, step
    assert je.flush() == te.flush()
    _assert_engines_equal(je, te)
    jp, tp = _preds(rng, 9)
    _run_equal(je, te, jp, tp)
    _run_equal(jr, tr, jp, tp)
    assert te.writer.queue_depth == 0 and te.writer.pending_units == 0


def test_dead_staged_rows_keep_their_slots_and_routing():
    # rows killed by a delete still take their page and slot, so a later
    # queue (in the next shard) lands where stage-time routing put it
    rng = np.random.default_rng(3)
    j, t = _pair(rng.uniform(0, 100, 150), shards=3, pages_per_shard=10,
                 spare_pages=64)
    jw, tw = JWriter(j), TWriter(t)
    for v in rng.uniform(0, 100, 60):
        assert jw.write(float(v)) == tw.write(float(v))
    assert tw.pending_shards() == [1, 2]
    assert jw.delete(20.0, 60.0) == tw.delete(20.0, 60.0)
    assert tw.stats.killed > 0
    _assert_writer_equal(jw, tw)
    assert jw.drain(1) == tw.drain(1)
    _assert_index_equal(j, t)
    assert jw.flush() == tw.flush()
    _assert_index_equal(j, t)
    _assert_writer_equal(jw, tw)


# ---------------------------------------------------------------------------
# The slab view
# ---------------------------------------------------------------------------

def test_slab_view_patched_in_place():
    rng = np.random.default_rng(31)
    j, t = _pair(rng.uniform(0, 100, 200))
    je = JEngine(j, batch=4, drain_policy="manual")
    te = TEngine(t, batch=4, drain_policy="manual")
    jp, tp = _preds(rng, 3)
    _run_equal(je, te, jp, tp)                 # builds the slab views
    table = t.table
    view = table._dev_shard
    assert view is not None and not view.pending
    for v in rng.uniform(0, 100, 10):
        je.write(float(v))
        te.write(float(v))
    assert je.flush() == te.flush() == 10
    assert table._dev_shard is view            # patched, not dropped
    assert not view.pending
    keys, valid = t._slabs()
    assert keys is view.keys and valid is view.valid
    jk, jv = j._slabs()
    _assert_equal(jk, keys, "patched keys")
    _assert_equal(jv, valid, "patched valid")
    # a delete patches the slabs it hit the same way
    assert je.delete(10.0, 80.0) == te.delete(10.0, 80.0) > 0
    assert table._dev_shard is view and not view.pending
    _assert_equal(j._slabs()[1], t._slabs()[1], "valid after delete")
    _run_equal(je, te, jp, tp)
    assert je.flush() == te.flush() == 0       # the vacuums
    # with no view, a drain leaves the upload to the next read
    table._dev_shard = None
    for e in (je, te):
        e.write(50.0)
        e.flush()
    assert table._dev_shard is None
    assert table.sync_slab_view() == 0
    _run_equal(je, te, jp, tp)
    assert not table._dev_shard.pending
    assert table.sync_slab_view() == 0         # nothing pending


def _ref_delete_rows(table, ids) -> None:
    """The port's ``PagedTable.delete_rows`` on the reference's table, which
    has none: the same bits cleared, the same dirty notes."""
    pages, slots = np.divmod(np.asarray(ids, np.int64), table.page_card)
    hit = table.valid[pages, slots]
    table.valid[pages[hit], slots[hit]] = False
    touched = np.unique(pages[hit])
    table.num_dirty += int((~table.dirty[touched]).sum())
    table.dirty[touched] = True
    table._dev = None
    table._dev_shard_stale = True              # the reference's own flag


# loaded rows (8 a page, 10 pages a shard), staged rows, pages the drain
# appends to
PATCH_CASES = {
    "partial_tail": (205, 2, 1),       # page 25 has room for both
    "full_tail": (200, 3, 1),          # page 25 opens
    "several_pages": (205, 30, 5),     # pages 25-29
    "dead_staged": (205, 20, 4),       # pages 25-28, half the rows killed
    "row_deletes": (205, 5, 2),        # pages 25-26, tail ids deleted
    "grows_table": (205, 30, 5),       # no spare page: the host table grows
    "empty_slab": (160, 4, 1),         # page 20 opens shard 2's slab
    "range_delete": (205, 30, 10),     # pages 25-29 and slab 2 (20-29), once
}


@pytest.mark.parametrize("case", list(PATCH_CASES))
def test_insert_drain_patches_only_its_pages(case):
    loaded, staged, patched = PATCH_CASES[case]
    rng = np.random.default_rng(43)
    j, t = _pair(rng.uniform(0, 100, loaded), pages_per_shard=10,
                 spare_pages=0 if case == "grows_table" else 64)
    kw = dict(batch=4, drain_policy="manual", auto_resummarize=False, top_k=6)
    je, te = JEngine(j, **kw), TEngine(t, **kw)
    jp, tp = _preds(rng, 3)
    table = t.table
    _run_equal(je, te, jp, tp)                 # builds the slab views
    view = table._dev_shard

    def assert_fresh(what):
        assert table._dev_shard is view and not view.pending, what
        for host, dev in ((table.keys, view.keys), (table.valid, view.valid)):
            whole = torch.zeros_like(dev).view(-1, table.page_card)
            whole[: table.num_pages] = torch.from_numpy(
                host[: table.num_pages])
            assert torch.equal(dev.view(-1, table.page_card), whole), what

    def delete_rows(ids):
        _ref_delete_rows(j.table, ids)
        assert te.delete_rows(ids) == len(ids)
        assert_fresh(f"delete_rows {ids}")

    if case == "row_deletes":
        delete_rows([203, 204])                # the partial tail page
    values = rng.uniform(0, 100, staged)
    if case == "dead_staged":
        values[::2] += 200.0
    for v in values:
        je.write(float(v))
        te.write(float(v))
    if case == "dead_staged":
        # only staged rows in range: the table and its view stay as they were
        assert je.delete(200.0, 400.0) == te.delete(200.0, 400.0) == 10
        assert not view.pending
    if case == "range_delete":
        # a range delete straight on the table (as the sync engine's is)
        # hits slab 2 only and is still pending when the drain patches
        key = float(table.keys[21, 3])
        assert j.table.delete_where(key, key) == \
            table.delete_where(key, key) == 1
        assert view.slabs == {2}
    before = te.writer.stats.patch_bytes
    je.writer.drain(1)
    te.writer.drain(1)                         # the insert queue only
    assert te.writer.queue_depth == 0
    assert te.writer.stats.patch_bytes - before == \
        patched * table.page_card * 5
    assert_fresh("after the drain")
    _assert_index_equal(j, t)
    _run_equal(je, te, jp, tp)
    if case == "row_deletes":
        delete_rows([205, 207])                # drained rows, tail page 25
        assert je.flush() == te.flush() == 0   # the vacuums
        _assert_index_equal(j, t)
        _run_equal(je, te, jp, tp)
    if case == "grows_table":
        assert table.capacity_pages > loaded // 8 + 1
    # nothing pending, no view: nothing copied; a table past the layout
    # drops the view
    assert table.sync_slab_view() == 0
    assert_fresh("nothing pending")
    table._dev_shard = None
    assert table.sync_slab_view() == 0
    _run_equal(je, te, jp, tp)                 # the next read rebuilds it
    view = table._dev_shard
    assert_fresh("rebuilt")
    table.append(np.zeros(21 * table.page_card, np.float32))
    assert table.num_pages > 40
    assert table._dev_shard is None and table.sync_slab_view() == 0
    with pytest.raises(ValueError, match="slab layout 4x10"):
        t._slabs()


# ---------------------------------------------------------------------------
# Refusals: same message, same rollback
# ---------------------------------------------------------------------------

def _raise_alike(jcall, tcall, exc=RuntimeError, match=None):
    with pytest.raises(exc, match=match) as je:
        jcall()
    with pytest.raises(exc, match=match) as te:
        tcall()
    assert str(je.value) == str(te.value)


def test_layout_full_refusal_equals_reference():
    rng = np.random.default_rng(37)
    j, t = _pair(rng.uniform(0, 100, 64), shards=2, pages_per_shard=5,
                 spare_pages=64)
    je = JEngine(j, batch=4, drain_policy="manual")
    te = TEngine(t, batch=4, drain_policy="manual")

    def fill(e):
        for v in np.linspace(0, 90, 100):
            e.write(float(v))

    _raise_alike(lambda: fill(je), lambda: fill(te), match="layout full")
    _assert_engines_equal(je, te)
    _run_equal(je, te, *_preds(rng, 4))
    assert je.flush() == te.flush()
    _assert_engines_equal(je, te)
    _run_equal(je, te, *_preds(rng, 4))


@pytest.mark.parametrize("policy", ["manual", "between_batches"])
def test_slot_capacity_refusal_rolls_back_like_reference(policy):
    j, t = _pair(np.linspace(0, 99, 64), shards=2, max_slots=12)
    je = JEngine(j, batch=4, drain_policy=policy, auto_resummarize=False)
    te = TEngine(t, batch=4, drain_policy=policy, auto_resummarize=False)
    for v in np.linspace(0, 99, 300):
        je.write(float(v))
        te.write(float(v))
    # two valid remaps drain before the insert queue refuses
    bounds = np.linspace(-1.0, 101.0, 33)
    je.writer.schedule_resummarize(bounds)
    te.writer.schedule_resummarize(bounds)
    jp, tp = _preds(np.random.default_rng(5), 3)
    if policy == "manual":
        _raise_alike(je.flush, te.flush, match="slot capacity")
    else:
        _run_equal(je, te, jp, tp)      # two batches: one remap unit each
        _raise_alike(lambda: je.run_all(jp), lambda: te.run_all(tp),
                     match="slot capacity")
        assert te._auto_drain_suspended
        for e in (je, te):
            e.queue.clear()
            e.slots = [None] * e.batch
    assert te.writer.stats.drains == 2 and te.writer.stats.resummarizes == 2
    _assert_engines_equal(je, te)
    _run_equal(je, te, jp, tp)                  # exact through the overlay
    assert je.writer.discard() == te.writer.discard() == 300
    _run_equal(je, te, jp, tp)
    _assert_engines_equal(je, te)
    je.write(50.0)
    te.write(50.0)
    assert je.flush() == te.flush() == 1
    _assert_engines_equal(je, te)


def test_mid_swap_guard_refuses_every_surface():
    rng = np.random.default_rng(41)
    j, t = _pair(rng.uniform(0, 100, 200))
    te = TEngine(t, batch=4)
    je = JEngine(j, batch=4)
    jp, tp = JPred.between(0, 50), TPred.between(0, 50)
    j.swap_in_flight = t.swap_in_flight = 2

    def surfaces(idx, e, w, p):
        return (lambda: idx.search_batch([p]), lambda: idx.plan_batch([p]),
                lambda: idx.search_batch_shard(0, [p]),
                lambda: idx.search_compact_batch([p], max_selected=4),
                lambda: idx.insert(1.0),
                lambda: idx.insert_batch(np.asarray([1.0])),
                idx.vacuum, lambda: idx.vacuum_shard(0),
                lambda: e.run_all([p]), lambda: e.write(1.0),
                lambda: e.delete(0.0, 1.0),
                lambda: w.schedule_resummarize(np.linspace(0, 1, 33)))

    for a, b in zip(surfaces(j, je, je.writer, jp),
                    surfaces(t, te, te.writer, tp)):
        _raise_alike(a, b, match="swap in flight")
    j.swap_in_flight = t.swap_in_flight = None
    for e in (je, te):
        e.queue.clear()
        e.slots = [None] * e.batch
    assert _run_equal(je, te, [jp], [tp]) == [_brute(t.table, 0, 50)]


def test_direct_insert_refused_while_rows_staged():
    rng = np.random.default_rng(43)
    j, t = _pair(rng.uniform(0, 100, 100))
    jw, tw = JWriter(j), TWriter(t)
    jw.write(5.0)
    tw.write(5.0)
    _raise_alike(lambda: j.insert(1.0), lambda: t.insert(1.0),
                 match="staged rows pending")
    _raise_alike(lambda: j.insert_batch(np.asarray([1.0, 2.0])),
                 lambda: t.insert_batch(np.asarray([1.0, 2.0])),
                 match="staged rows pending")
    assert jw.flush() == tw.flush() == 1
    j.insert(1.0)
    t.insert(1.0)
    _assert_index_equal(j, t)


def test_second_detached_and_foreign_writers_refuse():
    rng = np.random.default_rng(47)
    j, t = _pair(rng.uniform(0, 100, 100))
    jw, tw = JWriter(j), TWriter(t)
    jw.write(5.0)
    tw.write(5.0)
    _raise_alike(lambda: JWriter(j), lambda: TWriter(t),
                 match="already has a writer")
    jw.flush()
    tw.flush()
    jw2, tw2 = JWriter(j), TWriter(t)           # queue empty: allowed
    assert t.staging is tw2
    _raise_alike(lambda: jw.write(1.0), lambda: tw.write(1.0),
                 match="detached")
    _raise_alike(lambda: jw.delete(0.0, 1.0), lambda: tw.delete(0.0, 1.0),
                 match="detached")
    j2, t2 = _pair(rng.uniform(0, 100, 100))
    _raise_alike(lambda: JEngine(j2, batch=4, writer=jw2),
                 lambda: TEngine(t2, batch=4, writer=tw2), exc=ValueError,
                 match="different index")
    hidx = THippo.create(TTable.from_values(np.linspace(0, 9, 80), 8),
                         resolution=32, device="cpu")
    with pytest.raises(ValueError, match="ShardedHippoIndex"):
        TWriter(hidx)
    with pytest.raises(ValueError, match="sync"):
        TEngine(hidx, drain_policy="between_batches")
    assert TEngine(hidx).writer is None


def test_journal_is_refused_until_durable_storage(tmp_path):
    # the name is the one this test had while the journal was refused;
    # durable storage has landed, so it now holds the journal's contract:
    # a journaled writer appends each record before it stages, and a
    # failed append leaves nothing staged
    from repro.checkpointing.wal import Journal as JJournal
    from repro_torch.checkpointing.wal import Journal as TJournal
    rng = np.random.default_rng(59)
    j, t = _pair(np.sort(rng.uniform(0, 100, 200)))
    jw = JWriter(j, journal=JJournal(tmp_path / "j", 4, sync=False))
    tw = TWriter(t, journal=TJournal(tmp_path / "t", 4, sync=False))
    assert t.staging is tw and tw.journal.last_seqno == 0
    for v in rng.uniform(0, 120, 20):
        assert jw.write(float(v)) == tw.write(float(v))
        assert tw.journal.last_seqno == tw.stats.staged
    assert jw.delete(10.0, 20.0) == tw.delete(10.0, 20.0)
    bounds = np.linspace(-1.0, 121.0, 33)
    jw.schedule_resummarize(bounds)
    tw.schedule_resummarize(bounds)
    _assert_writer_equal(jw, tw)
    recs = tw.journal.replay()
    assert [r.kind for r in recs] == [1] * 20 + [2, 3]
    for f in sorted((tmp_path / "j" / "wal").iterdir()):
        assert f.read_bytes() == (tmp_path / "t" / "wal" / f.name).read_bytes()
    depth, pages = tw.queue_depth, t.table.num_pages
    for call in (lambda w: w.write(50.0), lambda w: w.delete(0.0, 100.0),
                 lambda w: w.schedule_resummarize(bounds)):
        tfi.crash_points.reset()
        tfi.crash_points.arm("wal.pre_append")
        try:
            with pytest.raises(tfi.InjectedCrash):
                call(tw)
        finally:
            tfi.crash_points.reset()
    assert (tw.queue_depth, t.table.num_pages, t.table.num_dirty) == \
        (depth, pages, j.table.num_dirty)
    assert tw.journal.last_seqno == 22
    _assert_writer_equal(jw, tw)


# ---------------------------------------------------------------------------
# A crash injected before the drain's swap
# ---------------------------------------------------------------------------

def test_crash_before_swap_leaves_rows_staged_and_counted():
    rng = np.random.default_rng(53)
    j, t = _pair(np.sort(rng.uniform(0, 100, 300)))
    je = JEngine(j, batch=4, drain_policy="manual")
    te = TEngine(t, batch=4, drain_policy="manual")
    for v in rng.uniform(0, 120, 40):
        je.write(float(v))
        te.write(float(v))
    jp, tp = _preds(rng, 4)
    before = _run_equal(je, te, jp, tp)
    snap = [f.clone() for f in t.state.shards]
    for fi, e in ((jfi, je), (tfi, te)):
        fi.crash_points.reset()
        fi.crash_points.arm("drain.pre_swap")
        try:
            with pytest.raises(fi.InjectedCrash, match="drain.pre_swap"):
                e.flush()
            assert fi.crash_points.fired("drain.pre_swap") == 1
        finally:
            fi.crash_points.reset()
    assert all(torch.equal(a, b) for a, b in zip(snap, t.state.shards))
    assert te.writer.queue_depth == 40
    _assert_engines_equal(je, te)
    assert _run_equal(je, te, jp, tp) == before
    assert je.flush() == te.flush() == 40
    _assert_engines_equal(je, te)
    assert _run_equal(je, te, jp, tp) == before


def test_writer_stats_fields_equal_reference():
    # the reference's fields, in its order, then the port's own counters
    # (row deletes and slab-patch bytes, which the reference lacks)
    from repro.runtime.writer import WriterStats as JStats
    assert list(WriterStats.__dataclass_fields__) == \
        list(JStats.__dataclass_fields__) + list(PORT_ONLY)
