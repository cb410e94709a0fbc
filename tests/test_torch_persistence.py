"""Port parity: durable storage (``repro_torch.checkpointing.snapshot``, the
writer's journal hooks and the engine's ``storage_dir``).

The same index (the reference's state carried in through
``convert.from_arrays``, or both packages' ``create`` for learned bounds,
whose models must be in the files too) and the same stream of writes,
deletes, drift re-summarizations and drains go through both packages'
durable engines: every file of the two directories (full snapshots,
deltas, compaction folds and the journal) must be byte-identical. A
directory written by either package recovers in the other to the same
counts, row ids, state fields, table and staged queues as in its own. The
vectorized bitmap codec gives the reference loop's bytes (hypothesis).
Then the port's counterparts of the reference's ``test_persistence.py``:
round trips, crash recovery, the delta chain's gap refusal, an
uncommitted partial, the fresh-directory guard, tombstone pruning,
compaction, the background persister's poison fallback, the resummarize
record before admission, and the watermark under its lock.
"""
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import repro.checkpointing.snapshot as jsnap
from repro.core import index as jix
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.runtime.engine import QueryEngine as JEngine
from repro.storage.table import PagedTable as JTable
import repro_torch.checkpointing.snapshot as tsnap
from repro_torch import convert
from repro_torch.checkpointing.layout import CorruptSnapshotError
from repro_torch.checkpointing.wal import Journal as TJournal
from repro_torch.core import bitmap as tbm
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.runtime import faultinject as tfi
from repro_torch.runtime.engine import QueryEngine as TEngine
from repro_torch.runtime.writer import MaintenanceWriter as TWriter
from repro_torch.storage.table import PagedTable as TTable
from test_torch_writer import _assert_index_equal, _assert_writer_equal

pytestmark = pytest.mark.persist

KW = dict(batch=8, top_k=6, wal_sync=False)


def _pair(values, summary="equal_mass", shards=4):
    """A reference index and the port's copy of it (``convert`` of the
    reference's arrays; ``create`` on both sides for learned bounds)."""
    jt = JTable.from_values(np.asarray(values, np.float32), 8,
                            spare_pages=256)
    j = JSharded.create(jt, num_shards=shards, resolution=32, density=0.25,
                        summary=summary)
    if summary == "learned":
        tt = TTable.from_values(np.asarray(values, np.float32), 8,
                                spare_pages=256)
        return j, TSharded.create(tt, num_shards=shards, resolution=32,
                                  density=0.25, summary=summary,
                                  device="cpu")
    sh = j.state.shards
    arrays = {f: np.asarray(getattr(sh, f)) for f in jix.HippoState._fields}
    arrays.update(summaries=np.asarray(j.state.summaries),
                  num_shards=j.spec.num_shards,
                  pages_per_shard=j.spec.pages_per_shard,
                  resolution=j.cfg.resolution, density=j.cfg.density,
                  page_card=j.cfg.page_card, max_slots=j.cfg.max_slots,
                  relocate_on_update=j.cfg.relocate_on_update,
                  keys=j.table.keys, valid=j.table.valid,
                  num_pages=j.table.num_pages, fill=j.table.fill,
                  bounds_epochs=j.bounds_epochs, summary=j.summary)
    return j, convert.from_arrays(arrays, device="cpu")


def _preds(rng, n):
    spans = [(float(lo), float(lo + w)) for lo, w in
             zip(rng.uniform(0, 140, n), rng.choice([0.0, 3.0, 30.0], n))]
    spans += [(5.0, 1.0), (-np.inf, np.inf)]
    return [JPred.between(*s) for s in spans], [TPred.between(*s) for s in spans]


def _files(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _assert_dirs_identical(a, b):
    fa, fb = _files(a), _files(b)
    assert list(fa) == list(fb)
    for name in fa:
        assert fa[name] == fb[name], name


def _serve(je, te, jp, tp):
    jt = [je.submit(p) for p in jp]
    tt = [te.submit(p) for p in tp]
    je.drain()
    te.drain()
    for a, b in zip(jt, tt):
        assert a.count == b.count, a.pred
        assert np.array_equal(a.row_ids, b.row_ids), a.pred
    return [b.count for b in tt]


def _assert_loaded_equal(live, loaded):
    """A port index against its reload: every state field, the summaries,
    epochs, counters and the table's pages (a reload's capacity is the
    page count it was saved with)."""
    for a, b in zip(live.state.shards, loaded.state.shards):
        assert torch.equal(a, b)
    assert torch.equal(live.state.summaries, loaded.state.summaries)
    assert np.array_equal(live.bounds_epochs, loaded.bounds_epochs)
    assert live.counters == loaded.counters and live.cfg == loaded.cfg
    n = live.table.num_pages
    assert (n, live.table.fill, live.table.num_dirty) == \
        (loaded.table.num_pages, loaded.table.fill, loaded.table.num_dirty)
    for f in ("keys", "valid", "dirty"):
        assert np.array_equal(getattr(live.table, f)[:n],
                              getattr(loaded.table, f)[:n]), f


def _value_brute(values, ps):
    v = np.asarray(values, np.float32)
    return np.asarray([((v >= p.lo) & (v <= p.hi)).sum() for p in ps],
                      np.int64)


# ---------------------------------------------------------------------------
# The same stream through both packages: the same bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("summary", ["equal_mass", "learned"])
def test_snapshots_and_journal_byte_identical_to_reference(tmp_path,
                                                           summary):
    rng = np.random.default_rng(3)
    j, t = _pair(np.sort(rng.uniform(0, 100, 400)), summary)
    kw = dict(KW, drain_policy="between_batches", drift_min_observed=16,
              compact_every=3)
    je = JEngine(j, storage_dir=tmp_path / "j", **kw)
    te = TEngine(t, storage_dir=tmp_path / "t", **kw)
    _assert_dirs_identical(tmp_path / "j", tmp_path / "t")
    for step in range(6):
        for v in rng.uniform(0, 130 + 10 * step, 20):     # drifts upward
            je.write(float(v))
            te.write(float(v))
        if step == 2:
            lo = float(rng.uniform(0, 90))
            assert je.delete(lo, lo + 4.0) == te.delete(lo, lo + 4.0) > 0
        # staged records (inserts, deletes, the drift trigger's remap)
        _assert_dirs_identical(tmp_path / "j", tmp_path / "t")
        _serve(je, te, *_preds(rng, 6))       # drains and commits
        _assert_dirs_identical(tmp_path / "j", tmp_path / "t")
    assert te.stats.resummarizes > 0 and te.stats.persists > 4
    assert any(p.name.startswith("delta_") for p in (tmp_path / "t").iterdir())
    assert te._base_epoch > 1               # a compaction fold happened
    assert je.flush() == te.flush()
    _assert_dirs_identical(tmp_path / "j", tmp_path / "t")
    assert te.stats.persists == je.stats.persists
    assert te.stats.persist_lag == je.stats.persist_lag == 0


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directory_recovers_in_the_other_package(tmp_path, writer):
    """A directory with a delta chain, staged rows captured by a commit and
    a journal suffix past it (the writer killed): both packages recover it
    to the same counts, row ids, state, table and staged queues."""
    rng = np.random.default_rng(5)
    j, t = _pair(np.sort(rng.uniform(0, 100, 300)))
    idx, engine = (j, JEngine) if writer == "reference" else (t, TEngine)
    eng = engine(idx, storage_dir=tmp_path, drain_policy="manual",
                 drift_min_observed=16, **KW)
    for v in rng.uniform(90, 130, 30):
        eng.write(float(v))
    eng.delete(20.0, 23.0)
    eng.flush()                               # a delta, staged rows drained
    for v in rng.uniform(0, 140, 12):
        eng.write(float(v))
    eng.writer.schedule_resummarize()         # journaled, not drained
    eng.write(77.0)
    eng.close()
    del eng
    je = JEngine.recover(tmp_path, snapshot_on_recover=False,
                         drain_policy="manual", **KW)
    te = TEngine.recover(tmp_path, snapshot_on_recover=False,
                         drain_policy="manual", device="cpu", **KW)
    assert te.index.device.type == "cpu"
    _assert_index_equal(je.index, te.index)
    _assert_writer_equal(je.writer, te.writer)
    assert te.writer.staged_rows == 13
    assert te.writer.pending_resummarize_shards() == [0, 1, 2, 3]
    assert te.stats.persist_lag == je.stats.persist_lag > 0
    jp, tp = _preds(rng, 10)
    _serve(je, te, jp, tp)
    assert je.flush() == te.flush() == 13
    _assert_index_equal(je.index, te.index)
    _assert_writer_equal(je.writer, te.writer)
    _serve(je, te, jp, tp)


def test_load_index_of_reference_snapshot_equals_reference(tmp_path):
    rng = np.random.default_rng(6)
    j, _ = _pair(np.sort(rng.uniform(0, 100, 300)), "learned")
    jw = JEngine(j, drain_policy="manual", batch=8).writer
    for v in rng.uniform(100, 120, 24):
        jw.write(float(v))
    jw.flush()
    jw.schedule_resummarize()
    jw.drain(max_units=2)                     # mixed bounds epochs
    for v in rng.uniform(100, 125, 5):
        jw.write(float(v))
    jsnap.save_index(tmp_path, j, wal_seqno=7)
    t, meta = tsnap.load_index(tmp_path, device="cpu")
    jl, jmeta = jsnap.load_index(tmp_path)
    assert meta == jmeta and meta["wal_seqno"] == 7
    _assert_index_equal(jl, t)
    assert t.summary == "learned"
    for a, b in zip(jl.summary_models, t.summary_models):
        assert np.array_equal(a.knots_x, b.knots_x)
        assert (a.n_knots, a.segments, a.max_error) == \
            (b.n_knots, b.segments, b.max_error)
    assert list(t.bounds_epochs) == [1, 1, 0, 0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tsnap.load_index(tmp_path)        # device=None is the card


# ---------------------------------------------------------------------------
# The bitmap codec: the reference loop's bytes
# ---------------------------------------------------------------------------

@st.composite
def _rows(draw):
    w = draw(st.sampled_from([1, 2, 13, 32]))
    n = draw(st.integers(0, 12))
    kinds = draw(st.lists(st.sampled_from(["zero", "ones", "alt", "runs",
                                           "random"]), min_size=n,
                          max_size=n))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, w), np.uint32)
    for i, k in enumerate(kinds):
        if k == "ones":
            rows[i] = 0xFFFFFFFF
        elif k == "alt":
            rows[i, ::2] = 0xAAAAAAAA
        elif k == "runs":
            rows[i] = np.repeat(rng.integers(0, 3, w), 1)[np.sort(
                rng.integers(0, w, w))]
        elif k == "random":
            rows[i] = rng.integers(0, 2**32, w, dtype=np.uint64)
    return rows


@settings(max_examples=150, deadline=None)
@given(_rows())
def test_vectorized_bitmap_codec_equals_reference_loop(rows):
    want = jsnap._encode_bitmaps(rows)
    got = tbm.rle_encode_rows(rows)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    back = tbm.rle_decode_rows(*got, rows.shape[1])
    assert back.dtype == np.uint32 and np.array_equal(back, rows)
    assert np.array_equal(jsnap._decode_bitmaps(*got, rows.shape[1]), back)


def test_bitmap_decode_refuses_like_reference():
    rows = np.zeros((3, 13), np.uint32)
    rows[1] = np.arange(13)
    flags, lens, data = tbm.rle_encode_rows(rows)
    assert flags.tolist() == [1, 0, 1]
    for args, match in (((flags, lens, data[:-1], 13), "shorter"),
                        ((flags, lens, data, 12), "decodes to")):
        with pytest.raises(CorruptSnapshotError, match=match):
            tbm.rle_decode_rows(*args)
        with pytest.raises(jsnap.CorruptSnapshotError, match=match):
            jsnap._decode_bitmaps(*args)
    assert np.array_equal(tbm.rle_decompress(tbm.rle_compress(rows[1])),
                          rows[1])


# ---------------------------------------------------------------------------
# The port's counterparts of the reference's persistence cases
# ---------------------------------------------------------------------------

def _tidx(values, **kw):
    return TSharded.create(TTable.from_values(np.asarray(values, np.float32),
                                              8, spare_pages=256),
                           num_shards=4, resolution=32, density=0.25,
                           device="cpu", **kw)


def _durable(root, base, **kw):
    return TEngine(_tidx(base), batch=8, drain_policy="manual",
                   auto_resummarize=False, storage_dir=root, **kw)


def _recover(root, **kw):
    return TEngine.recover(root, drain_policy="manual", device="cpu",
                           auto_resummarize=False, **kw)


def _ps():
    return [TPred(lo=5.0, hi=1.0), TPred.equality(50.0),
            TPred.between(20.0, 24.0), TPred.between(108.0, 114.0),
            TPred.between(80.0, 125.0), TPred.between(-1e30, 1e30)]


@pytest.mark.parametrize("staged", [False, True])
def test_round_trip_counts_and_rows_bit_identical(tmp_path, staged):
    rng = np.random.default_rng(7 + staged)
    base = np.sort(rng.uniform(0, 100, 300))
    idx = _tidx(base)
    w = TWriter(idx)
    drained = rng.uniform(100, 130, 48)
    for v in drained:
        w.write(float(v))
    w.flush()
    w.schedule_resummarize()
    w.drain(max_units=2)
    pending = rng.uniform(125, 140, 12) if staged else np.zeros(0)
    for v in pending:
        w.write(float(v))
    eng = TEngine(idx, batch=8, drain_policy="manual", top_k=16, writer=w)
    want = eng.run_all(_ps())
    np.testing.assert_array_equal(
        want, _value_brute(np.concatenate([base, drained, pending]), _ps()))
    idx.save(tmp_path)
    idx2, w2, _ = tsnap.recover_index(tmp_path, wal_sync=False, device="cpu")
    eng2 = TEngine(idx2, batch=8, drain_policy="manual", top_k=16, writer=w2)
    np.testing.assert_array_equal(eng2.run_all(_ps()), want)
    _assert_loaded_equal(idx, idx2)
    assert (w2.queue_depth, w2.staged_rows, w2.queue_depths(),
            w2.pending_resummarize_shards()) == \
        (w.queue_depth, w.staged_rows, w.queue_depths(),
         w.pending_resummarize_shards())
    assert np.array_equal(w2._pending_bounds, w._pending_bounds)
    assert idx2.nbytes() == idx.nbytes()
    w.flush()
    w2.flush()
    _assert_loaded_equal(idx, idx2)


def test_crash_pre_append_loses_only_the_unacknowledged_write(tmp_path):
    rng = np.random.default_rng(0)
    base = np.sort(rng.uniform(0, 100, 200))
    eng = _durable(tmp_path, base)
    acked = [float(v) for v in rng.uniform(100, 130, 20)]
    for v in acked:
        eng.write(v)
    tfi.crash_points.reset()
    tfi.crash_points.arm("wal.pre_append")
    try:
        with pytest.raises(tfi.InjectedCrash):
            eng.write(999.0)
    finally:
        tfi.crash_points.reset()
    assert eng.writer.queue_depth == len(acked)
    del eng
    eng2 = _recover(tmp_path)
    eng2.flush()
    np.testing.assert_array_equal(
        eng2.run_all(_ps()), _value_brute(np.concatenate([base, acked]), _ps()))


def test_crash_post_swap_pre_truncate_never_double_applies(tmp_path,
                                                           monkeypatch):
    rng = np.random.default_rng(2)
    base = np.sort(rng.uniform(0, 100, 200))
    eng = _durable(tmp_path, base)
    writes = [float(v) for v in rng.uniform(100, 130, 24)]
    for v in writes:
        eng.write(v)

    def boom(self):
        raise RuntimeError("killed before journal truncation")
    monkeypatch.setattr(TJournal, "reset", boom)
    with pytest.raises(RuntimeError, match="truncation"):
        eng.flush()
    monkeypatch.undo()
    assert TJournal(tmp_path, 4, sync=False).replay()
    expected = np.concatenate([base, writes])
    del eng
    eng2 = _recover(tmp_path)
    eng2.flush()
    np.testing.assert_array_equal(eng2.run_all(_ps()),
                                  _value_brute(expected, _ps()))
    assert eng2.run_all([TPred.between(-1e30, 1e30)])[0] == expected.size


def test_partial_uncommitted_snapshot_is_never_loaded(tmp_path):
    rng = np.random.default_rng(3)
    eng = _durable(tmp_path, np.sort(rng.uniform(0, 100, 200)))
    for v in rng.uniform(100, 120, 8):
        eng.write(float(v))
    eng.flush()
    committed = tsnap.latest_epoch(tmp_path)
    want = eng.run_all(_ps())
    partial = tmp_path / f"snap_{committed + 5}"
    partial.mkdir()
    (partial / "index.bin").write_bytes(b"\x00garbage, never to be read")
    assert tsnap.latest_epoch(tmp_path) == committed
    del eng
    np.testing.assert_array_equal(_recover(tmp_path).run_all(_ps()), want)


def test_fresh_dir_guard_refuses_existing_durable_state(tmp_path):
    base = np.sort(np.random.default_rng(4).uniform(0, 100, 160))
    eng = _durable(tmp_path, base)
    eng.write(105.0)
    del eng
    with pytest.raises(ValueError, match="recover"):
        _durable(tmp_path, base)
    with pytest.raises(ValueError, match="writer-backed"):
        TEngine(_tidx(base), drain_policy="sync", storage_dir=tmp_path / "x")
    with pytest.raises(ValueError, match="derives storage_dir"):
        TEngine.recover(tmp_path, device="cpu", writer=None)
    with pytest.raises(RuntimeError, match="storage_dir"):
        TEngine(_tidx(base), batch=8).save()
    for bad in ({"snapshot_mode": "bogus"}, {"compact_every": 0},
                {"compact_ratio": 0.0}):
        with pytest.raises(ValueError):
            TEngine(_tidx(base), batch=8, **bad)


def test_load_surfaces_corruption_and_disk_usage_splits(tmp_path):
    idx = _tidx(np.sort(np.random.default_rng(8).uniform(0, 100, 160)))
    snap = idx.save(tmp_path)
    u = tsnap.disk_usage(snap)
    assert u["table"] > 0 and u["index"] > 0
    assert u["table"] + u["index"] == u["total"]
    assert u == jsnap.disk_usage(snap)
    f = snap / "index.bin"
    blob = bytearray(f.read_bytes())
    blob[len(blob) // 2] ^= 0x01
    f.write_bytes(bytes(blob))
    with pytest.raises(CorruptSnapshotError):
        TSharded.load(tmp_path, device="cpu")


def test_delta_chain_round_trips_then_gap_is_refused(tmp_path):
    rng = np.random.default_rng(22)
    base = np.sort(rng.uniform(0, 100, 200))
    idx = _tidx(base)
    w = TWriter(idx)
    tsnap.save_index(tmp_path, idx, wal_seqno=0)
    vals = list(base)
    for k in range(2):
        for v in rng.uniform(100.0, 120.0, 8):
            w.write(float(v))
            vals.append(float(v))
        w.flush()
        if k:
            w.delete(10.0, 14.0)
            vals = [v for v in vals if not 10.0 <= v <= 14.0]
            w.flush()
        idx.save_delta(tmp_path, shards=w.dirty_checkpoint_shards())
        w.clear_checkpoint_dirty()
    assert tsnap.latest_delta_seq(tmp_path, 1) == 2
    idx2, meta = tsnap.load_index(tmp_path, device="cpu")
    assert meta["deltas"] == 2
    _assert_loaded_equal(idx, idx2)
    np.testing.assert_array_equal(
        TEngine(idx2, batch=8, drain_policy="manual").run_all(_ps()),
        _value_brute(vals, _ps()))
    shutil.rmtree(tmp_path / "delta_1_1")
    with pytest.raises(CorruptSnapshotError, match="delta chain"):
        tsnap.load_index(tmp_path, device="cpu")
    with pytest.raises(CorruptSnapshotError, match="delta chain"):
        tsnap.delta_chain(tmp_path, 1)


def test_prune_renames_to_tombstone_before_rmtree(tmp_path, monkeypatch):
    idx = _tidx(np.sort(np.random.default_rng(23).uniform(0, 100, 160)))
    tsnap.save_index(tmp_path, idx, keep=1)
    monkeypatch.setattr(tsnap.shutil, "rmtree", lambda *a, **k: None)
    tsnap.save_index(tmp_path, idx, keep=1)
    monkeypatch.undo()
    tomb = tmp_path / "snap_1.tombstone"
    assert tomb.exists() and (tomb / "COMMITTED").exists()
    assert not (tmp_path / "snap_1").exists()
    assert tsnap.latest_epoch(tmp_path) == 2
    idx2, _ = tsnap.load_index(tmp_path, device="cpu")
    _assert_loaded_equal(idx, idx2)
    tsnap.save_index(tmp_path, idx, keep=1)
    assert not tomb.exists()


def test_incremental_engine_builds_chain_then_compacts(tmp_path):
    rng = np.random.default_rng(25)
    base = np.sort(rng.uniform(0, 100, 200))
    eng = _durable(tmp_path, base, compact_every=3, compact_ratio=1e9)
    vals = [float(v) for v in base]
    for step in range(4):
        for v in rng.uniform(100.0, 130.0, 8):
            eng.write(float(v))
            vals.append(float(v))
        eng.flush()
    names = {p.name for p in tmp_path.iterdir() if p.is_dir()}
    assert {"snap_1", "delta_1_1", "delta_1_2", "delta_1_3",
            "snap_2"} <= names
    full = (tmp_path / "snap_1" / "index.bin").stat().st_size
    for k in range(1, 4):
        assert (tmp_path / f"delta_1_{k}" / "index.bin").stat().st_size < full
    assert eng.stats.persists == 5 and eng.stats.persist_lag == 0
    del eng
    eng2 = _recover(tmp_path)
    assert (eng2._base_epoch, eng2._delta_seq) == (3, 0)
    eng2.flush()
    np.testing.assert_array_equal(eng2.run_all(_ps()), _value_brute(vals, _ps()))


def test_background_save_poison_falls_back_to_sync_full(tmp_path,
                                                        monkeypatch):
    from repro_torch.runtime.persister import PersisterPoisoned
    rng = np.random.default_rng(26)
    base = np.sort(rng.uniform(0, 100, 200))
    eng = _durable(tmp_path, base, background_save=True)
    vals = [float(v) for v in base]

    def boom(*a, **k):
        raise RuntimeError("disk full")
    monkeypatch.setattr(tsnap, "write_delta_snapshot", boom)
    for v in rng.uniform(100.0, 120.0, 8):
        eng.write(float(v))
        vals.append(float(v))
    eng.flush()
    with pytest.raises(PersisterPoisoned):
        eng.flush_durable()
    assert eng._persister.stats_snapshot().failed == 1
    monkeypatch.undo()
    for v in rng.uniform(120.0, 130.0, 8):
        eng.write(float(v))
        vals.append(float(v))
    eng.flush()
    eng.flush_durable()
    assert not eng._persister.poisoned
    eng.close()
    eng2 = _recover(tmp_path)
    eng2.flush()
    np.testing.assert_array_equal(eng2.run_all(_ps()), _value_brute(vals, _ps()))


def test_resummarize_journals_before_admission(tmp_path):
    rng = np.random.default_rng(31)
    idx = _tidx(np.sort(rng.uniform(0, 100, 200)), summary="learned")
    writer = TWriter(idx, journal=TJournal(tmp_path, 4, sync=False))
    for v in rng.uniform(0, 100, 64):
        writer.write(float(v))
    writer.flush()

    def state():
        return (writer._pending_model, writer._pending_bounds,
                writer.stats.learned_refits, writer.stats.learned_fallbacks,
                writer.pending_resummarize_shards())

    before = state()
    wm = writer.journal.last_seqno
    tfi.crash_points.reset()
    tfi.crash_points.arm("wal.pre_append")
    try:
        with pytest.raises(tfi.InjectedCrash):
            writer.schedule_resummarize()
    finally:
        tfi.crash_points.reset()
    assert state() == before and writer.journal.last_seqno == wm
    writer.schedule_resummarize()
    assert writer.journal.last_seqno == wm + 1
    assert writer.journal.replay()[-1].policy == "learned"
    assert writer.pending_resummarize_shards() == [0, 1, 2, 3]


def test_background_watermark_advances_under_lock(tmp_path):
    rng = np.random.default_rng(33)
    eng = _durable(tmp_path, np.sort(rng.uniform(0, 100, 200)),
                   background_save=True)
    for v in rng.uniform(100, 120, 8):
        eng.write(float(v))
    eng.flush()
    eng.flush_durable()
    with eng._durable_lock:
        wm = eng._durable_watermark
    assert wm == eng.journal.last_seqno > 0
    eng._sync_writer_stats()
    assert eng.stats.persist_lag == 0 and eng.stats.persist_pending == 0
    eng.close()
    eng.close()                                   # idempotent
