"""Durable refresh functions on the port: the journal's group-insert and
row-delete records, ``write_many``, and recovery of TPC-H-like RF1/RF2
traffic (an order's rows inserted together, loaded orders deleted by row
id) on small indexes on the CPU.

- Both record kinds round-trip, keep their bytes through
  ``truncate_through``, and replay in admission order among inserts,
  range deletes and re-summarizations; a torn group record drops the
  whole order and nothing before it; an empty, misrouted or oversized
  record is refused unwritten.
- A journal that holds none of the port's kinds stays byte-identical to the
  reference's and replays there, with the sync on or off.
- A synced append syncs its own file once, with ``os.fdatasync`` where the
  platform has it.
- ``write_many`` stages exactly what as many ``write`` calls stage: the
  same queues, positions, drift reservoir, ``WriterStats`` and counts, and
  one record (one sync) where ``write`` appends one a row; a group the
  shard layout cannot hold is refused whole. Its drift trigger is checked
  after the group's last row, where ``write`` checks after each row.
- A crash at each registered ``faultinject`` site, under a mix of
  ``write_many`` and ``delete_rows``, recovers to a plain NumPy replay of
  the acknowledged operations over the loaded column; so does a journal
  with no commit after the first snapshot (``snapshot_on_drain=False``),
  whose row deletes name rows drained after that snapshot.
- Traced, the ``write`` and ``delete_rows`` spans hold ``hippo.wal.append``
  and ``hippo.wal.sync``; the journal's sync counters reach
  ``EngineStats``.
"""
import dataclasses
import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro.checkpointing.wal import Journal as JJournal
from repro_torch.checkpointing import wal
from repro_torch.checkpointing.wal import (KIND_DELETE, KIND_INSERT,
                                           KIND_INSERT_GROUP, KIND_RESUM,
                                           KIND_ROW_DELETE, Journal)
from repro_torch.core.partition import ShardedHippoIndex
from repro_torch.core.predicate import Predicate
from repro_torch.runtime.engine import QueryEngine
from repro_torch.runtime.fault import resilient_serve
from repro_torch.runtime.faultinject import SITES, crash_points
from repro_torch.storage.table import PagedTable

pytestmark = pytest.mark.persist

PAGE_CARD = 8
SPANS = [(5.0, 1.0), (0.0, 10.0), (20.0, 24.0), (40.0, 60.0), (55.0, 140.0),
         (-1e30, 1e30)]
# Site -> the durable engine whose commit path runs that site, as the
# reference's sweep configures it
SITE_CONFIG = {
    "wal.pre_append": {},
    "drain.pre_swap": {},
    "delta.pre_commit": {},
    "snapshot.pre_commit": {"snapshot_mode": "full"},
    "compact.pre_commit": {"compact_every": 2},
    "truncate.pre": {},
    "persist.in_flight": {"background_save": True},
}
ENGINE_KW = dict(batch=8, drain_policy="manual", auto_resummarize=False,
                 wal_sync=False)


@pytest.fixture(autouse=True)
def _clean_crash_points():
    crash_points.reset()
    yield
    crash_points.reset()


def _index(values, shards=4, spare_pages=256):
    table = PagedTable.from_values(np.asarray(values, np.float32), PAGE_CARD,
                                   spare_pages=spare_pages)
    return ShardedHippoIndex.create(table, num_shards=shards, resolution=32,
                                    density=0.25, device="cpu")


def _orders(rng, n, lo=0, hi=120):
    """n orders of 1-7 rows each, a day apiece."""
    return [rng.integers(lo, hi, rng.integers(1, 8)).astype(np.float64)
            for _ in range(n)]


def _loaded(rng, n):
    """A loaded column whose orders sit together in load order: the column
    and each order's [a, b) row ids."""
    sizes = rng.integers(1, 8, n)
    ends = np.cumsum(sizes)
    keys = np.concatenate([np.full(s, d) for s, d in
                           zip(sizes, rng.integers(0, 120, n))])
    return keys.astype(np.float32), list(zip((ends - sizes).tolist(),
                                             ends.tolist()))


# ---------------------------------------------------------------------------
# The records
# ---------------------------------------------------------------------------

def _mixed(j):
    j.append_insert(1, 10.5)                               # 1
    j.append_insert_group([0, 0, 1], [3.0, 4.25, 5.0])     # 2
    j.append_delete(3.0, 4.0)                              # 3
    j.append_row_delete(np.asarray([7, 2, 9], np.int64))   # 4
    j.append_resummarize(np.linspace(0.0, 1.0, 9).astype(np.float32))  # 5
    j.append_insert_group([1], [np.float32(7.25)])         # 6
    j.append_row_delete([2**40 + 3])                       # 7


def test_both_kinds_round_trip_in_admission_order(tmp_path):
    j = Journal(tmp_path, 2, sync=False)
    _mixed(j)
    recs = j.replay()
    assert [r.kind for r in recs] == [
        KIND_INSERT, KIND_INSERT_GROUP, KIND_DELETE, KIND_ROW_DELETE,
        KIND_RESUM, KIND_INSERT_GROUP, KIND_ROW_DELETE]
    assert [r.seqno for r in recs] == list(range(1, 8))
    g = recs[1]
    assert g.shards.dtype == np.uint32 and g.values.dtype == np.float32
    assert g.shards.tolist() == [0, 0, 1]
    assert g.values.tolist() == [3.0, 4.25, 5.0]
    assert recs[3].row_ids.dtype == np.int64
    assert recs[3].row_ids.tolist() == [7, 2, 9]          # as given
    assert recs[5].values.tolist() == [7.25]
    assert recs[6].row_ids.tolist() == [2**40 + 3]
    # the port's kinds live in global.log beside the deletes
    assert not (tmp_path / "wal" / "shard_0.log").exists()
    j.close()
    again = Journal(tmp_path, 2, sync=False)
    assert again.last_seqno == 7
    assert [r.seqno for r in again.replay(after=3)] == [4, 5, 6, 7]


def test_truncation_keeps_the_new_records_byte_for_byte(tmp_path):
    j = Journal(tmp_path, 2, sync=False)
    _mixed(j)
    log = tmp_path / "wal" / "global.log"
    whole = log.read_bytes()
    j.truncate_through(1)          # only shard_1.log's insert goes
    assert log.read_bytes() == whole
    j.truncate_through(4)
    tail = log.read_bytes()
    assert whole.endswith(tail) and len(tail) < len(whole)
    assert [r.seqno for r in Journal(tmp_path, 2, sync=False).replay()] == \
        [5, 6, 7]


@pytest.mark.parametrize("cut", [1, 4, 12, 23])
def test_a_torn_group_record_drops_the_whole_order(tmp_path, cut):
    j = Journal(tmp_path, 3, sync=False)
    j.append_insert(2, 1.0)
    j.append_row_delete([4, 5])
    j.append_insert_group([0, 1, 1], [6.0, 7.0, 8.0])     # 24 B payload
    j.close()
    log = tmp_path / "wal" / "global.log"
    log.write_bytes(log.read_bytes()[:-cut])
    recs = Journal(tmp_path, 3, sync=False).replay()
    assert [(r.seqno, r.kind) for r in recs] == [(1, KIND_INSERT),
                                                 (2, KIND_ROW_DELETE)]


@pytest.mark.parametrize("bad", ["empty_group", "shard", "lengths",
                                 "empty_ids", "oversized"])
def test_a_bad_record_is_refused_unwritten(tmp_path, bad):
    j = Journal(tmp_path, 2, sync=False)
    j.append_insert(0, 1.0)
    call = {"empty_group": lambda: j.append_insert_group([], []),
            "shard": lambda: j.append_insert_group([0, 2], [1.0, 2.0]),
            "lengths": lambda: j.append_insert_group([0], [1.0, 2.0]),
            "empty_ids": lambda: j.append_row_delete([]),
            "oversized": lambda: j.append_row_delete(
                np.arange((1 << 21) + 1))}[bad]
    with pytest.raises(ValueError):
        call()
    assert j.last_seqno == 1 and len(j.replay()) == 1
    assert sum(f.stat().st_size for f in (tmp_path / "wal").iterdir()) == \
        17 + 8


def _reference_kinds(j):
    j.append_insert(1, 10.5)
    j.append_delete(3.0, 4.0)
    j.append_insert(0, -2.0)
    j.append_resummarize(np.linspace(0.0, 1.0, 9).astype(np.float32),
                         "learned")
    j.append_insert(1, np.float32(7.25))


@pytest.mark.parametrize("sync", [False, True])
def test_a_journal_of_the_reference_kinds_is_the_reference_s(tmp_path, sync):
    for name, journal in (("port", Journal), ("reference", JJournal)):
        j = journal(tmp_path / name, 2, sync=sync)
        _reference_kinds(j)
        j.close()
    names = sorted(f.name for f in (tmp_path / "port" / "wal").iterdir())
    assert names == sorted(f.name for f in
                           (tmp_path / "reference" / "wal").iterdir())
    for name in names:
        assert (tmp_path / "port" / "wal" / name).read_bytes() == \
            (tmp_path / "reference" / "wal" / name).read_bytes(), name
    got = JJournal(tmp_path / "port", 2, sync=False).replay()
    assert [(r.seqno, r.kind) for r in got] == \
        [(1, 1), (2, 2), (3, 1), (4, 3), (5, 1)]


@pytest.mark.parametrize("sync", [False, True])
def test_the_journal_counts_its_appends(tmp_path, sync):
    j = Journal(tmp_path, 2, sync=sync)
    _mixed(j)
    st = j.stats()
    payloads = 8 + 24 + 8 + 24 + 1 + 9 * 4 + 8 + 8
    assert sum(f.stat().st_size for f in (tmp_path / "wal").iterdir()) == \
        7 * 17 + payloads
    assert st.syncs == (7 if sync else 0)
    assert (st.sync_s > 0) == sync
    st.syncs = 0                    # a copy: the journal's own is intact
    assert j.stats().syncs == (7 if sync else 0)


def test_an_append_syncs_its_file_s_data_once(tmp_path, monkeypatch):
    assert wal._sync_record is getattr(os, "fdatasync", os.fsync)
    fds = []
    monkeypatch.setattr(wal, "_sync_record", fds.append)
    j = Journal(tmp_path, 2)
    j.append_insert_group([0, 1], [3.0, 4.0])
    j.append_row_delete([7, 9])
    j.append_insert(1, 5.0)
    h = j._handles
    assert fds == [h["global.log"].fileno()] * 2 + [h["shard_1.log"].fileno()]
    assert j.stats().syncs == 3
    assert [r.kind for r in j.replay()] == [KIND_INSERT_GROUP,
                                            KIND_ROW_DELETE, KIND_INSERT]


# ---------------------------------------------------------------------------
# write_many
# ---------------------------------------------------------------------------

def _writer_state(eng):
    w = eng.writer
    stats = {k: v for k, v in dataclasses.asdict(w.stats).items()
             if not k.endswith("drain_us")}
    return ({s: (q.values, q.live) for s, q in w._queues.items()},
            w.queue_depth, w.staged_rows, stats, w.drift.hits.tolist(),
            w.drift.sample().tolist(), w.drift.observed,
            w.drift.out_of_range)


def _engine_stats(eng):
    return {k: v for k, v in dataclasses.asdict(eng.stats).items()
            if k != "drain_us"}


@pytest.mark.parametrize("policy", ["manual", "between_batches"])
def test_write_many_stages_what_as_many_writes_stage(tmp_path, policy):
    rng = np.random.default_rng(3)
    base = rng.integers(0, 120, 300).astype(np.float32)
    orders = _orders(rng, 40)
    preds = [Predicate.between(lo, hi) for lo, hi in SPANS]
    engines = []
    for name in ("rows", "groups"):
        eng = QueryEngine(_index(base), batch=8, drain_policy=policy,
                          auto_resummarize=False,
                          storage_dir=tmp_path / name, wal_sync=False,
                          snapshot_on_drain=False)
        engines.append(eng)
    by_row, by_group = engines
    for k, days in enumerate(orders):
        for v in days:
            by_row.write(v)
        assert by_group.write_many(days) == days.size
        if k % 8 == 7:
            assert by_row.run_all(preds).tolist() == \
                by_group.run_all(preds).tolist()
        assert _writer_state(by_row) == _writer_state(by_group), k
    ra, rb = _engine_stats(by_row), _engine_stats(by_group)
    rows = int(sum(d.size for d in orders))
    assert ra["writes"] == rb["writes"] == rows
    assert (len(by_row.journal.replay()), len(by_group.journal.replay())) \
        == (rows, len(orders))
    # the rest equal, but persist_lag: records since the last commit
    ra, rb = ({k: v for k, v in r.items()
               if not k.startswith(("journal_", "persist_lag"))}
              for r in (ra, rb))
    assert ra == rb
    for eng in engines:
        eng.flush()
    t0, t1 = by_row.index.table, by_group.index.table
    assert np.array_equal(t0.keys, t1.keys)
    assert np.array_equal(t0.valid, t1.valid)
    assert by_row.run_all(preds).tolist() == by_group.run_all(preds).tolist()
    assert by_group.write_many([]) == 0
    for eng in engines:
        eng.close()


def test_write_many_checks_the_drift_trigger_after_its_last_row(tmp_path):
    # orders past the bounds' top edge: the edge-bucket overflow crosses
    # the threshold at the 16th row (drift_min_observed), inside the 6th
    # order. n writes schedule the remap after that row; write_many after
    # the order's last row. Up to that order the two agree; after it both
    # hold the same rows and a remap of every shard, whose bounds come from
    # different samples: the row engine's without the order's last 5 rows
    rng = np.random.default_rng(5)
    base = rng.integers(0, 120, 300).astype(np.float32)
    orders = _orders(rng, 60, lo=100, hi=260)
    preds = [Predicate.between(lo, hi) for lo, hi in SPANS]
    by_row, by_group = (
        QueryEngine(_index(base), batch=8, drain_policy="manual",
                    auto_resummarize=True, drift_min_observed=16,
                    storage_dir=tmp_path / name, wal_sync=False,
                    snapshot_on_drain=False)
        for name in ("rows", "groups"))
    row_at = group_at = None
    rows = 0
    for k, days in enumerate(orders):
        for v in days:
            by_row.write(v)
            rows += 1
            if row_at is None and by_row.writer.pending_resummarize_shards():
                row_at = (k, rows)
        by_group.write_many(days)
        if by_group.writer.pending_resummarize_shards():
            group_at = k
            break
        assert row_at is None, (k, row_at)
        assert _writer_state(by_row) == _writer_state(by_group), k
    assert row_at == (5, 16) and group_at == 5
    assert sum(d.size for d in orders[:6]) == 21
    assert not np.array_equal(by_row.writer._pending_bounds,
                              by_group.writer._pending_bounds)
    for eng in (by_row, by_group):
        assert eng.writer.pending_resummarize_shards() == [0, 1, 2, 3]
        assert eng.stats.writes == 21 and eng.writer.queue_depth == 21
        eng.flush()
    assert by_row.run_all(preds).tolist() == by_group.run_all(preds).tolist()
    assert not by_group.writer.pending_resummarize_shards()
    for eng in (by_row, by_group):
        eng.close()


def test_a_group_the_layout_cannot_hold_is_refused_whole(tmp_path):
    # 4 shards of 2 pages hold 64 rows: once the 64th is staged, no staged
    # row has a page to land on
    table = PagedTable.from_values(np.arange(63, dtype=np.float32),
                                   PAGE_CARD, spare_pages=8)
    idx = ShardedHippoIndex.create(table, num_shards=4, resolution=32,
                                   pages_per_shard=2, device="cpu")
    eng = QueryEngine(idx, batch=8, drain_policy="manual",
                      storage_dir=tmp_path, wal_sync=False)
    seqno = eng.journal.last_seqno
    eng.write(1.0)                  # the 64th row: the last slot
    with pytest.raises(RuntimeError, match="shard layout full"):
        eng.write_many([2.0, 3.0])
    assert eng.writer.queue_depth == 1 and eng.stats.writes == 1
    assert eng.journal.last_seqno == seqno + 1
    eng.close()


# ---------------------------------------------------------------------------
# Recovery: a crash at every site, the acknowledged operations replayed
# ---------------------------------------------------------------------------

class Model:
    """The acknowledged operations replayed in NumPy over the loaded column:
    a row's id is its position, a new row takes the next."""

    def __init__(self, base):
        self.keys = list(np.asarray(base, np.float32))
        self.live = [True] * len(self.keys)

    def insert(self, days):
        self.keys += list(np.asarray(days, np.float32))
        self.live += [True] * len(days)

    def delete(self, ids):
        for i in ids:
            self.live[i] = False

    def counts(self, spans=SPANS):
        k = np.asarray(self.keys, np.float32)[np.asarray(self.live)]
        return np.asarray([((k >= lo) & (k <= hi)).sum() for lo, hi in spans],
                          np.int64)


def _rf_ops(rng, orders, n_base):
    """RF1/RF2 interleaved order by order: ("w", days) a new order,
    ("d", ids) the next loaded order's rows; every fifth delete names the
    first rows of the new order four before instead, whose ids follow the
    loaded rows and which an earlier step drained."""
    ops, new, k = [], [], 0
    pos = n_base
    for i, days in enumerate(_orders(rng, len(orders))):
        ops.append(("w", days))
        new.append((pos, days.size))
        pos += days.size
        if i % 5 == 4:
            a, n = new[i - 4]
            ops.append(("d", np.arange(a, a + min(n, 2))))
        else:
            a, b = orders[k]
            ops.append(("d", np.arange(a, b)))
            k += 1
    return ops


def _workload(ops, model, chunk=5):
    """Resumption-aware: the cursor advances only past an acknowledged
    operation. Each step first drains what a recovery restaged, so every
    acknowledged row has its id, then issues a chunk and drains it."""
    cursor = {"i": 0}

    def step(eng):
        eng.flush()
        end = min(cursor["i"] + chunk, len(ops))
        while cursor["i"] < end:
            kind, arg = ops[cursor["i"]]
            if kind == "w":
                assert eng.write_many(arg) == len(arg)     # acknowledged
                model.insert(arg)
            else:
                eng.delete_rows(arg)
                model.delete(arg)
            cursor["i"] += 1
        eng.flush()
        return cursor["i"] >= len(ops)

    return step


def _serve(root, ops, base, site, **cfg):
    kw = dict(ENGINE_KW, **cfg)
    eng = QueryEngine(_index(base), storage_dir=root, **kw)
    model = Model(base)
    if site is not None:
        crash_points.arm(site, times=1)
    eng2, stats = resilient_serve(root, _workload(ops, model), engine=eng,
                                  recover_kwargs=dict(kw, device="cpu"),
                                  max_restarts=6, backoff_base_s=0.001,
                                  hang_restart=False)
    fired = crash_points.fired(site) if site is not None else 0
    if cfg.get("background_save"):
        eng2.flush_durable()
    preds = [Predicate.between(lo, hi) for lo, hi in SPANS]
    counts = eng2.run_all(preds)
    eng2.close()
    again = QueryEngine.recover(root, snapshot_on_recover=False,
                                **dict(kw, device="cpu",
                                       background_save=False))
    fresh = again.run_all(preds)
    again.close()
    return model, counts, fresh, stats, fired


@pytest.mark.fault
@pytest.mark.parametrize("site", SITES)
def test_a_crash_at_every_site_recovers_the_acknowledged_orders(tmp_path,
                                                                site):
    assert set(SITE_CONFIG) == set(SITES)
    rng = np.random.default_rng(SITES.index(site) + 40)
    base, orders = _loaded(rng, 30)
    ops = _rf_ops(rng, orders, base.size)
    model, counts, fresh, stats, fired = _serve(
        tmp_path, ops, base, site, **SITE_CONFIG[site])
    assert fired >= 1, f"{site} was never on the executed path"
    want = model.counts()
    assert sum(not x for x in model.live) > 60
    np.testing.assert_array_equal(counts, want, err_msg=site)
    np.testing.assert_array_equal(fresh, want, err_msg=site)
    if site != "persist.in_flight":
        assert stats.crashes >= 1 and stats.restores >= 1


@pytest.mark.fault
@pytest.mark.parametrize("site", [None, "wal.pre_append", "drain.pre_swap"])
def test_a_journal_with_no_commit_after_the_first_recovers_by_replay(
        tmp_path, site):
    """PostgreSQL's defaults put no checkpoint in the run: one snapshot, then
    every record replayed; row deletes name new rows drained after it."""
    rng = np.random.default_rng(77)
    base, orders = _loaded(rng, 30)
    ops = _rf_ops(rng, orders, base.size)
    model, counts, fresh, stats, fired = _serve(
        tmp_path, ops, base, site, snapshot_on_drain=False)
    assert [p.name for p in tmp_path.iterdir() if p.name.startswith(
        ("snap_", "delta_"))] == ["snap_1"] or site is not None
    want = model.counts()
    np.testing.assert_array_equal(counts, want)
    np.testing.assert_array_equal(fresh, want)
    assert (fired >= 1) == (site is not None)


def test_recovery_drains_before_a_row_delete_of_drained_rows(tmp_path):
    base = np.arange(40, dtype=np.float32)
    eng = QueryEngine(_index(base), storage_dir=tmp_path,
                      snapshot_on_drain=False, **ENGINE_KW)
    eng.write_many([5.0, 6.0, 7.0])
    eng.write(8.0)
    eng.flush()                      # ids 40-43, drained: no commit
    eng.write_many([9.0, 10.0])      # staged, ids 44-45 once drained
    assert eng.delete_rows([41, 0]) == 2
    eng.close()                      # a crash: no save
    again = QueryEngine.recover(tmp_path, snapshot_on_recover=False,
                                device="cpu", **ENGINE_KW)
    model = Model(base)
    model.insert([5.0, 6.0, 7.0, 8.0, 9.0, 10.0])
    model.delete([41, 0])
    preds = [Predicate.between(lo, hi) for lo, hi in SPANS]
    np.testing.assert_array_equal(again.run_all(preds), model.counts())
    again.flush()
    np.testing.assert_array_equal(again.run_all(preds), model.counts())
    assert not again.index.table.valid.ravel()[[0, 41]].any()
    again.close()


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

def _inside(child, parent) -> bool:
    return (child.thread == parent.thread
            and parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


def test_the_write_side_spans_hold_the_journal_s(tmp_path):
    base = np.arange(200, dtype=np.float32) % 50
    eng = QueryEngine(_index(base), batch=8, drain_policy="manual",
                      storage_dir=tmp_path, wal_sync=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.write(3.0)
        eng.write_many([4.0, 5.0, 6.0])
        eng.delete_rows([1, 2, 3])
    events = [e for e in prof.events() if e.name.startswith("hippo.")]
    outer = [e for e in events if e.name in ("hippo.engine.write",
                                             "hippo.engine.delete_rows")]
    assert sorted(e.name for e in outer) == ["hippo.engine.delete_rows",
                                             "hippo.engine.write",
                                             "hippo.engine.write"]
    for name in ("hippo.wal.append", "hippo.wal.sync"):
        inner = [e for e in events if e.name == name]
        assert len(inner) == 3, name
        for e in inner:
            assert not e.is_user_annotation
        for o in outer:
            assert sum(_inside(e, o) for e in inner) == 1, (name, o.name)
    st = eng.stats
    assert st.journal_syncs == 3 and st.journal_sync_us > 0
    eng.close()
    again = QueryEngine.recover(tmp_path, snapshot_on_recover=False,
                                device="cpu", drain_policy="manual")
    assert again.stats.journal_syncs == 0
    model = Model(base)
    model.insert([3.0, 4.0, 5.0, 6.0])
    model.delete([1, 2, 3])
    preds = [Predicate.between(lo, hi) for lo, hi in SPANS]
    np.testing.assert_array_equal(again.run_all(preds), model.counts())
    again.close()
