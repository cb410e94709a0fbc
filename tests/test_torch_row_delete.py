"""Row deletes (``QueryEngine.delete_rows``, ``MaintenanceWriter.delete_rows``,
``PagedTable.delete_rows`` and ``sync_slab_view``) on small indexes on the
CPU.

- Counts after row deletes equal a plain NumPy count over a model of the live
  rows, under the sync and writer-backed engines, with staged rows pending,
  in the compact and dense modes, on a ``ShardedHippoIndex`` and (sync) a
  ``HippoIndex``; each call returns the live tuples it deleted.
- Deleting the rows a ``delete(lo, hi)`` would delete leaves the same table,
  the same index state after the vacuums and the same device slab.
- After every row delete the slab view, patched in place, equals a fresh
  upload of the host table; so does it at the read after each of the sync
  engine's mutations, which copies only what the mutation changed.
- Refusals leave everything as it was: an id past the tail (a staged row
  has no id), a negative id, a call while a swap is in flight; with a
  journal attached such a refusal appends no record, and a delete that
  goes through appends one, its ids, before anything changes.
- The call does no whole-table work: no range mask, no dirty scan, no slab
  copy; ``on_depth`` fires on it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.hippo import HippoIndex
from repro_torch.core.partition import ShardedHippoIndex
from repro_torch.core.predicate import Predicate
from repro_torch.runtime.engine import QueryEngine
from repro_torch.storage.table import PagedTable

PAGE_CARD = 10
VALUES = np.random.default_rng(71).integers(0, 300, 2403).astype(np.float32)


def _engine(index: str, policy: str, mode: str = "compact", **kw
            ) -> QueryEngine:
    table = PagedTable.from_values(VALUES, PAGE_CARD, spare_pages=64)
    if index == "hippo":
        idx = HippoIndex.create(table, resolution=32, device="cpu")
    else:
        idx = ShardedHippoIndex.create(table, num_shards=3, resolution=32,
                                       device="cpu")
    return QueryEngine(idx, batch=8, mode=mode, drain_policy=policy, **kw)


def _preds(rng, n: int = 16) -> list[Predicate]:
    los = rng.integers(0, 330, n)
    widths = np.resize([0, 4, 40, 200], n)
    return [Predicate.between(float(a), float(a + w))
            for a, w in zip(los, widths)]


class Model:
    """The live rows by position: the loaded values, then every write in
    order (a staged row takes the next position when it drains)."""

    def __init__(self):
        self.keys = VALUES.astype(np.float64).tolist()
        self.live = [True] * len(self.keys)

    def write(self, eng: QueryEngine, v: float) -> None:
        eng.write(v)
        self.keys.append(v)
        self.live.append(True)

    def delete(self, ids) -> int:
        n = 0
        for i in sorted(set(int(i) for i in ids)):
            n += self.live[i]
            self.live[i] = False
        return n

    def counts(self, preds) -> np.ndarray:
        k = np.asarray(self.keys)
        live = np.asarray(self.live)
        return np.asarray([int((live & (k >= p.lo) & (k <= p.hi)).sum())
                           for p in preds])


def _tail(eng: QueryEngine) -> int:
    """Positions with a row id now: the loaded rows and the drained ones."""
    if eng.writer is None:
        return eng.stats.writes + VALUES.size
    return VALUES.size + eng.writer.stats.drained_rows


CASES = [("sharded", "sync", "compact"), ("sharded", "sync", "dense"),
         ("sharded", "between_batches", "compact"),
         ("sharded", "between_batches", "dense"),
         ("sharded", "manual", "compact"), ("sharded", "manual", "dense"),
         ("hippo", "sync", "compact"), ("hippo", "sync", "dense")]


@pytest.mark.parametrize("index,policy,mode", CASES)
def test_counts_after_row_deletes_equal_brute_force(index, policy, mode):
    rng = np.random.default_rng(200 + CASES.index((index, policy, mode)))
    eng = _engine(index, policy, mode)
    model = Model()
    preds = _preds(rng)
    assert np.array_equal(eng.run_all(preds), model.counts(preds))
    for round_ in range(5):
        for v in rng.integers(0, 330, 24):
            model.write(eng, float(v))
        if round_ == 3 and eng.writer is not None:
            eng.flush()             # drained rows take ids, deletable below
        tail = _tail(eng)
        ids = rng.integers(0, tail, 60)
        ids = np.concatenate([ids, ids[:5], [tail - 1]])   # repeats, the last
        want = model.delete(ids)
        assert eng.delete_rows(ids) == want
        assert eng.delete_rows(ids[:10]) == 0              # already deleted
        if policy == "manual" and round_ != 3:
            assert eng.writer.staged_rows > 0              # the overlay works
        assert np.array_equal(eng.run_all(preds), model.counts(preds)), round_
    assert eng.stats.deletes == len(VALUES) + eng.stats.writes \
        - sum(model.live)
    if eng.writer is not None:
        eng.flush()
        assert not eng.writer.pending_units and not eng.index.table.num_dirty
        assert np.array_equal(eng.run_all(preds), model.counts(preds))


def _state(idx) -> list[torch.Tensor]:
    if isinstance(idx, ShardedHippoIndex):
        return list(idx.state.shards) + [idx.state.summaries]
    return list(idx.state)


@pytest.mark.parametrize("index,policy", [("sharded", "sync"),
                                          ("sharded", "between_batches"),
                                          ("hippo", "sync")])
def test_row_deletes_equal_the_range_delete_they_replace(index, policy):
    rng = np.random.default_rng(73)
    by_range, by_rows = _engine(index, policy), _engine(index, policy)
    preds = _preds(rng)
    for e in (by_range, by_rows):
        e.run_all(preds)                                # fresh device views
    for lo, hi in ((40.0, 55.0), (0.0, 3.0), (120.0, 121.0), (299.0, 400.0)):
        t = by_rows.index.table
        live = t.valid[: t.num_pages] & (t.keys[: t.num_pages] >= lo) \
            & (t.keys[: t.num_pages] <= hi)
        ids = np.flatnonzero(live.ravel())
        assert by_range.delete(lo, hi) == by_rows.delete_rows(ids[::-1]) > 0
        for e in (by_range, by_rows):
            e.flush()
        a, b = by_range.index, by_rows.index
        for f in ("keys", "valid", "dirty"):
            assert np.array_equal(getattr(a.table, f), getattr(b.table, f)), f
        assert a.table.num_dirty == b.table.num_dirty == 0
        assert all(torch.equal(x, y) for x, y in zip(_state(a), _state(b)))
        assert dataclasses.asdict(a.counters) == dataclasses.asdict(b.counters)
        views = (lambda i: i._slabs()) if index == "sharded" \
            else (lambda i: i._views())
        assert all(torch.equal(x, y) for x, y in zip(views(a), views(b)))
        assert np.array_equal(by_range.run_all(preds), by_rows.run_all(preds))


def _fresh_upload(table: PagedTable, shape) -> tuple:
    total = shape[0] * shape[1]
    keys = torch.zeros((total, PAGE_CARD), dtype=torch.float32)
    valid = torch.zeros((total, PAGE_CARD), dtype=torch.bool)
    keys[: table.num_pages] = torch.from_numpy(table.keys[: table.num_pages])
    valid[: table.num_pages] = torch.from_numpy(
        table.valid[: table.num_pages])
    return keys.view(shape), valid.view(shape)


def test_the_patched_slab_equals_a_fresh_upload():
    rng = np.random.default_rng(79)
    eng = _engine("sharded", "between_batches", drain_units=2)
    table = eng.index.table
    preds = _preds(rng)
    eng.run_all(preds)
    view = table._dev_shard
    for round_ in range(6):
        for v in rng.integers(0, 330, 12):
            eng.write(float(v))
        eng.run_all(preds[:8])                 # drains: the slab patch
        ids = rng.integers(0, VALUES.size + eng.writer.stats.drained_rows, 40)
        assert eng.delete_rows(ids) > 0
        assert table._dev_shard is view and not view.pending
        keys, valid = _fresh_upload(table, view.keys.shape)
        assert torch.equal(view.keys, keys) and torch.equal(view.valid, valid)


@pytest.mark.parametrize("mutation", ["write", "delete", "delete_rows"])
def test_a_sync_mutation_is_patched_at_the_next_read(mutation, monkeypatch):
    """The sync engine patches no view itself: the next read copies what
    the mutation changed into the same view tensors."""
    rng = np.random.default_rng(103)
    eng = _engine("sharded", "sync")
    table = eng.index.table
    pps = eng.index.spec.pages_per_shard
    model = Model()
    preds = _preds(rng)
    eng.run_all(preds)
    view = table._dev_shard
    copied, sync = [], PagedTable.sync_slab_view

    def counted(self):
        copied.append(sync(self))
        return copied[-1]
    monkeypatch.setattr(PagedTable, "sync_slab_view", counted)
    if mutation == "write":
        for v in (5.0, 6.0, 7.0):              # the tail page's free slots
            model.write(eng, v)
        want = 1 * PAGE_CARD * 5
    elif mutation == "delete":
        lo, hi = 100.0, 104.0
        n = table.num_pages
        hit = table.valid[:n] & (table.keys[:n] >= lo) & (table.keys[:n] <= hi)
        model.delete(np.flatnonzero(hit.ravel()))
        slabs = np.unique(np.flatnonzero(hit.any(axis=1)) // pps)
        want = sum(min(pps, n - s * pps) for s in slabs) * PAGE_CARD * 5
        assert eng.delete(lo, hi) == hit.sum() > 0      # and its vacuum
    else:
        ids = [3, 4, 995, 2402]
        model.delete(ids)
        assert eng.delete_rows(ids) == 4                # and its vacuum
        want = 4 * 8
    assert np.array_equal(eng.run_all(preds), model.counts(preds))
    assert table._dev_shard is view and not view.pending
    assert sum(copied) == want
    keys, valid = _fresh_upload(table, view.keys.shape)
    assert torch.equal(view.keys, keys) and torch.equal(view.valid, valid)


def _snapshot(eng: QueryEngine) -> tuple:
    t = eng.index.table
    return (t.valid.copy(), t.dirty.copy(), t.num_dirty, t._dev_shard.pending,
            t._dev_shard.valid.clone(), dataclasses.asdict(eng.writer.stats),
            eng.writer.queue_depth, eng.writer.staged_rows,
            dataclasses.asdict(eng.stats))


def _assert_same(a: tuple, b: tuple) -> None:
    for x, y in zip(a, b):
        same = torch.equal(x, y) if isinstance(x, torch.Tensor) else \
            np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
        assert same


def test_ids_past_the_tail_and_negative_ids_are_refused_unchanged():
    rng = np.random.default_rng(83)
    eng = _engine("sharded", "manual")
    eng.run_all(_preds(rng))
    for v in (1.0, 2.0, 3.0):
        eng.write(v)                           # staged: no ids yet
    before = _snapshot(eng)
    tail = VALUES.size
    for ids in ([tail], [5, 6, tail + 1], [-1, 7], [tail + 2, -3]):
        with pytest.raises(IndexError, match="outside the table"):
            eng.delete_rows(ids)
        _assert_same(before, _snapshot(eng))
    assert eng.delete_rows([tail - 1, tail - 1]) == 1
    assert eng.delete_rows([tail - 1]) == 0
    assert eng.delete_rows(np.zeros((0,), np.int64)) == 0
    eng.flush()
    # the drained rows now have ids: the first staged row is the old tail
    assert eng.delete_rows([tail, tail + 2]) == 2
    sync = _engine("sharded", "sync")
    with pytest.raises(IndexError, match="outside the table"):
        sync.delete_rows([tail])
    assert not sync.index.table.num_dirty and sync.stats.deletes == 0


def test_a_journaled_or_mid_swap_writer_refuses_row_deletes(tmp_path):
    from repro_torch.checkpointing.wal import Journal
    rng = np.random.default_rng(89)
    eng = _engine("sharded", "manual")
    eng.run_all(_preds(rng))
    journal = Journal(tmp_path / "j", 3, sync=False)
    eng.writer.journal = journal
    eng.write(4.0)
    before = _snapshot(eng)
    seqno = journal.last_seqno
    # an id past the tail (the staged row's) is refused unjournaled
    with pytest.raises(IndexError):
        eng.delete_rows([0, 1, VALUES.size])
    _assert_same(before, _snapshot(eng))
    assert journal.last_seqno == seqno == 1
    eng.index.swap_in_flight = 1
    with pytest.raises(RuntimeError, match="swap in flight"):
        eng.delete_rows([0, 1, 2])
    eng.index.swap_in_flight = None
    _assert_same(before, _snapshot(eng))
    assert journal.last_seqno == 1
    assert eng.delete_rows([2, 0, 1, 1]) == 3
    [rec] = journal.replay(after=1)
    assert rec.row_ids.tolist() == [0, 1, 2]


def test_a_row_delete_does_no_whole_table_work(monkeypatch):
    rng = np.random.default_rng(97)
    eng = _engine("sharded", "manual")
    eng.run_all(_preds(rng))
    table = eng.index.table

    def refuse(*a, **k):
        raise AssertionError("whole-table work on the row-delete path")
    monkeypatch.setattr(PagedTable, "delete_where", refuse)
    monkeypatch.setattr(PagedTable, "_shard_views", refuse)
    monkeypatch.setattr(ShardedHippoIndex, "dirty_shards", refuse)
    stats = eng.writer.stats
    before = (stats.patch_bytes, stats.rows_deleted, table.num_dirty)
    ids = np.asarray([3, 4, 5, 995, 1800, 2402])
    assert eng.delete_rows(ids) == 6
    # one 8 B id a deleted row, notes on the four pages it touched
    assert (stats.patch_bytes, stats.rows_deleted, table.num_dirty) == \
        (before[0] + 48, before[1] + 6, before[2] + 4)
    assert not table._dev_shard.pending
    monkeypatch.undo()
    assert sorted(eng.writer.pending_vacuum_shards()) == \
        sorted({int(p) // eng.index.spec.pages_per_shard
                for p in ids // PAGE_CARD})


def test_on_depth_drains_on_a_row_delete():
    rng = np.random.default_rng(101)
    eng = _engine("sharded", "on_depth", drain_depth=6)
    preds = _preds(rng)
    eng.run_all(preds)
    assert eng.delete_rows([0, 1]) == 2         # one dirty page: below depth
    assert eng.index.table.num_dirty == 1 and eng.writer.stats.vacuums == 0
    ids = np.arange(8) * PAGE_CARD * 7          # seven more pages
    assert eng.delete_rows(ids) == 7            # id 0 already deleted
    assert eng.index.table.num_dirty == 0 and eng.writer.stats.vacuums > 0
    assert eng.stats.deletes == 9 and eng.stats.drains > 0
    model = Model()
    model.delete([0, 1, *ids])
    assert np.array_equal(eng.run_all(preds), model.counts(preds))
