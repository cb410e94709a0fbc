"""Port parity: drift telemetry and re-summarization.

``histogram.DriftTracker`` and ``histogram.rebuild`` are host numpy in both
packages: after the same stream (NaN and infinite values included) the hit
counters, out-of-range count and reservoir must be equal, and rebuilt
bounds bit-equal. A remap drained through the writer must leave every state
field and ``bounds_epochs`` equal to the reference's, a batch served while
the remap is partly drained must be exact on every path, a refused remap
must roll back alike, and ``convert.from_arrays`` must carry a remapped
reference index's epochs and summary policy.
"""
import numpy as np
import pytest

from repro.core import histogram as jhg
from repro.core import index as jix
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.runtime.engine import QueryEngine as JEngine
from repro.runtime.writer import MaintenanceWriter as JWriter
from repro.storage.table import PagedTable as JTable
from repro_torch import convert
from repro_torch.core import histogram as thg
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.runtime.engine import QueryEngine as TEngine
from repro_torch.runtime.writer import MaintenanceWriter as TWriter
from repro_torch.storage.table import PagedTable as TTable


def _hist_pair(lo=0.0, hi=100.0, h=10):
    return jhg.build_uniform(lo, hi, h), thg.build_uniform(lo, hi, h,
                                                           device="cpu")


def _tracker_equal(a, b):
    assert np.array_equal(a.hits, b.hits)
    assert (a.observed, a.out_of_range, a.resolution) == \
        (b.observed, b.out_of_range, b.resolution)
    assert np.array_equal(a.sample(), b.sample(), equal_nan=True)
    assert a.edge_overflow_ratio == b.edge_overflow_ratio
    assert np.array_equal(np.asarray(a.armed_histogram.bounds),
                          b.armed_histogram.bounds.numpy())


@pytest.mark.parametrize("reservoir", [64, 4096])
def test_drift_tracker_equal_after_the_same_stream(reservoir):
    rng = np.random.default_rng(11)
    stream = rng.uniform(-20.0, 140.0, 3000).astype(np.float32)
    stream[::97] = np.nan
    stream[5::211] = np.inf
    stream[7::223] = -np.inf
    jh, th = _hist_pair()
    ja = jhg.DriftTracker(jh, reservoir_size=reservoir)
    ta = thg.DriftTracker(th, reservoir_size=reservoir)
    ja.observe(stream[:700])
    ta.observe(stream[:700])
    for v in stream[700:900]:                 # the scalar path
        ja.observe(v)
        ta.observe(v)
    for part in np.array_split(stream[900:], 7):
        ja.observe(part)
        ta.observe(part)
    ja.observe(np.zeros(0))
    ta.observe(np.zeros(0))
    _tracker_equal(ja, ta)
    assert ta.hits[-1] > 0 and ta.out_of_range > 0
    jh2, th2 = _hist_pair(-50.0, 300.0, 16)
    ja.rearm(jh2)
    ta.rearm(th2)
    assert ta.observed == 0 and ta.sample().size == 0
    ja.observe(stream[:300])
    ta.observe(stream[:300])
    _tracker_equal(ja, ta)


def _reservoirs():
    rng = np.random.default_rng(7)
    return {
        "drift": rng.uniform(100.0, 200.0, 4096).astype(np.float32),
        "constant": np.full(512, 42.0, np.float32),
        "duplicate_heavy": rng.choice(
            np.asarray([1.0, 2.0, 3.0], np.float32), 512),
        "single_point_drift": np.full(512, 1e6, np.float32),
        "two_distinct_far": np.asarray([0.5] * 500 + [1e7] * 12, np.float32),
        "large_magnitude_narrow": (1e9 + rng.uniform(0, 1e-3, 512)
                                   ).astype(np.float32),
    }


@pytest.mark.parametrize("name", sorted(_reservoirs()))
def test_rebuild_bounds_bit_equal(name):
    sample = _reservoirs()[name]
    rng = np.random.default_rng(0)
    old = rng.uniform(0.0, 100.0, 20_000).astype(np.float32)
    for h in (8, 64, 400):
        for jbase, tbase in (_hist_pair(0.0, 100.0, h),
                             (jhg.build(old, h), thg.build(old, h, "cpu"))):
            for kw in ({}, {"resolution": 16},
                       {"old_count": 20_000, "new_count": 1_000},
                       {"old_count": 0, "new_count": 0}):
                a = np.asarray(jhg.rebuild(jbase, sample, **kw).bounds)
                got = thg.rebuild(tbase, sample, **kw)
                assert got.bounds.device == tbase.bounds.device
                b = got.bounds.numpy()
                assert a.dtype == b.dtype and np.array_equal(
                    a.view(np.uint32), b.view(np.uint32)), (h, kw)
    for m, base in zip((jhg, thg), _hist_pair(0.0, 1.0, 4)):
        with pytest.raises(ValueError, match="non-empty sample"):
            m.rebuild(base, np.zeros(0))


# ---------------------------------------------------------------------------
# Remaps through the writer
# ---------------------------------------------------------------------------

def _pair(values, shards=4, **kw):
    values = np.asarray(values, np.float32)
    return (JSharded.create(JTable.from_values(values, 8, spare_pages=256),
                            num_shards=shards, resolution=32, density=0.25,
                            **kw),
            TSharded.create(TTable.from_values(values, 8, spare_pages=256),
                            num_shards=shards, resolution=32, density=0.25,
                            device="cpu", **kw))


def _state_equal(j, t):
    for f in jix.HippoState._fields:
        a = np.asarray(getattr(j.state.shards, f))
        b = getattr(t.state.shards, f).numpy()
        assert np.array_equal(a.view(b.dtype) if a.dtype == np.uint32 else a,
                              b), f
    assert np.array_equal(np.asarray(j.state.summaries).view(np.int32),
                          t.state.summaries.numpy())
    assert np.array_equal(j.bounds_epochs, t.bounds_epochs)
    assert t.bounds_epochs.dtype == j.bounds_epochs.dtype
    assert np.array_equal(j.table.keys, t.table.keys)
    assert np.array_equal(j.table.valid, t.table.valid)


DRIFT_SPANS = [(5.0, 1.0), (50.0, 50.0), (20.0, 24.0), (108.0, 114.0),
               (80.0, 125.0), (-1e30, 1e30)]


def _all_paths_equal(j, t, jw, tw, pending=()):
    """Compact, fused dense and routed dense counts equal the reference's
    and brute force (table plus the staged rows)."""
    jp = [JPred.between(*s) for s in DRIFT_SPANS]
    tp = [TPred.between(*s) for s in DRIFT_SPANS]
    pending = np.asarray(pending, np.float32)
    live = t.table.valid[: t.table.num_pages]
    keys = t.table.keys[: t.table.num_pages]
    want = [int((live & (keys >= lo) & (keys <= hi)).sum())
            + int(((pending >= lo) & (pending <= hi)).sum())
            for lo, hi in DRIFT_SPANS]
    kw = dict(batch=8, drain_policy="manual")
    for mode in ("compact", "dense"):
        got = TEngine(t, mode=mode, writer=tw, **kw).run_all(tp)
        ref = JEngine(j, mode=mode, writer=jw, **kw).run_all(jp)
        assert list(got) == list(ref) == want, mode
    assert list(t.search_batch(tp).counts.numpy()) == want
    res_j = j.search_compact_batch(jp, max_selected=4, top_k=4)
    res_t = t.search_compact_batch(tp, max_selected=4, top_k=4)
    for f in res_j._fields:
        assert np.array_equal(np.asarray(getattr(res_j, f)),
                              getattr(res_t, f).numpy()), f


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("staged", [False, True])
def test_remap_state_and_epochs_equal(num_shards, staged):
    rng = np.random.default_rng(3 * num_shards + staged)
    j, t = _pair(np.sort(rng.uniform(0, 100, 300)), shards=num_shards)
    kw = dict(batch=8, drain_policy="manual", auto_resummarize=False)
    je, te = JEngine(j, **kw), TEngine(t, **kw)
    for v in rng.uniform(100, 130, 48):
        je.write(float(v))
        te.write(float(v))
    assert je.flush() == te.flush()
    pending = rng.uniform(125, 140, 12) if staged else np.zeros(0)
    for v in pending:
        je.write(float(v))
        te.write(float(v))
    _all_paths_equal(j, t, je.writer, te.writer, pending)
    jh = je.writer.schedule_resummarize()
    th = te.writer.schedule_resummarize()
    assert np.array_equal(np.asarray(jh.bounds), th.bounds.numpy())
    assert je.writer.drain(num_shards) == te.writer.drain(num_shards) == 0
    assert list(t.bounds_epochs) == [1] * num_shards
    assert te.writer.queue_depth == pending.size
    _state_equal(j, t)
    _all_paths_equal(j, t, je.writer, te.writer, pending)
    assert je.flush() == te.flush() == pending.size
    _state_equal(j, t)
    _all_paths_equal(j, t, je.writer, te.writer)
    # the tracker rearmed on the new bounds in both
    _tracker_equal(je.writer.drift, te.writer.drift)


def test_batch_served_mid_remap_is_exact():
    rng = np.random.default_rng(17)
    j, t = _pair(np.sort(rng.uniform(0, 100, 400)))
    jw, tw = JWriter(j), TWriter(t)
    for v in rng.uniform(100, 120, 32):
        jw.write(float(v))
        tw.write(float(v))
    assert jw.flush() == tw.flush() == 32
    jw.schedule_resummarize()
    tw.schedule_resummarize()
    for w in (jw, tw):
        w.drain(max_units=2)
    assert list(t.bounds_epochs) == [1, 1, 0, 0]          # mid-transition
    assert not np.array_equal(t.state.shards.bounds[0].numpy(),
                              t.state.shards.bounds[3].numpy())
    _state_equal(j, t)
    _all_paths_equal(j, t, jw, tw)
    # rows staged during the partial remap drain after it, under the new
    # bounds; until then the overlay counts them
    staged = rng.uniform(110, 125, 20)
    for v in staged:
        jw.write(float(v))
        tw.write(float(v))
    _all_paths_equal(j, t, jw, tw, staged)
    assert jw.flush() == tw.flush() == 20
    assert list(t.bounds_epochs) == [1, 1, 1, 1]
    _state_equal(j, t)
    _all_paths_equal(j, t, jw, tw)


@pytest.mark.parametrize("bad", ["short", "tied"])
def test_refused_remap_rolls_back_alike(bad):
    rng = np.random.default_rng(23)
    j, t = _pair(np.sort(rng.uniform(0, 100, 200)))
    jw, tw = JWriter(j), TWriter(t)
    bounds = (np.linspace(0.0, 100.0, 10) if bad == "short"
              else np.concatenate([np.zeros(2), np.linspace(1, 100, 31)]))
    for w in (jw, tw):
        w.schedule_resummarize(bounds)
    with pytest.raises(RuntimeError, match="resummarize refused") as je:
        jw.flush()
    with pytest.raises(RuntimeError, match="resummarize refused") as te:
        tw.flush()
    assert str(je.value) == str(te.value)
    assert t.swap_in_flight is None
    assert list(t.bounds_epochs) == [0, 0, 0, 0]
    assert tw.pending_resummarize_shards() == [0, 1, 2, 3]
    assert tw.stats.resummarizes == jw.stats.resummarizes == 0
    _state_equal(j, t)
    _all_paths_equal(j, t, jw, tw)
    good = np.linspace(-1.0, 101.0, 33)
    for w in (jw, tw):
        w.schedule_resummarize(good)
        w.flush()
    assert list(t.bounds_epochs) == [1, 1, 1, 1]
    _state_equal(j, t)
    _all_paths_equal(j, t, jw, tw)
    with pytest.raises(RuntimeError, match="no drift sample"):
        TWriter(_pair(np.arange(50.0))[1]).schedule_resummarize()


def test_auto_trigger_schedules_and_drains_alike():
    rng = np.random.default_rng(29)
    j, t = _pair(np.sort(rng.uniform(0, 100, 200)))
    kw = dict(batch=4, drift_threshold=0.5, drift_min_observed=8)
    je, te = JEngine(j, **kw), TEngine(t, **kw)
    for v in rng.uniform(100, 115, 16):
        je.write(float(v))
        te.write(float(v))
    assert te.writer.pending_resummarize_shards() == [0, 1, 2, 3]
    assert te.stats.edge_overflow_ratio == je.stats.edge_overflow_ratio == 1.0
    jp = [JPred.between(*s) for s in DRIFT_SPANS]
    tp = [TPred.between(*s) for s in DRIFT_SPANS]
    while te.writer.pending_units:
        assert list(je.run_all(jp)) == list(te.run_all(tp))
        assert np.array_equal(j.bounds_epochs, t.bounds_epochs)
    assert not je.writer.pending_units
    assert te.stats.resummarizes == 4 and te.stats.edge_overflow_ratio == 0.0
    for f in ("pruning_before_resummarize", "window_selected_pages",
              "window_table_pages", "drains", "drained_rows",
              "peak_queue_depth"):
        assert getattr(je.stats, f) == getattr(te.stats, f), f
    assert te.stats.pruning_after_resummarize == \
        je.stats.pruning_after_resummarize
    _state_equal(j, t)


# ---------------------------------------------------------------------------
# convert.py carries the epochs of an index the reference remapped
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("summary", ["equal_mass", "learned"])
def test_convert_carries_epochs_and_summary(summary):
    rng = np.random.default_rng(31)
    j, _ = _pair(np.sort(rng.uniform(0, 100, 400)), summary=summary)
    jw = JWriter(j)
    for v in rng.uniform(100, 120, 32):
        jw.write(float(v))
    jw.flush()
    jw.schedule_resummarize()
    jw.drain(max_units=2)                      # epochs [1, 1, 0, 0]
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
    t = convert.from_arrays(arrays, device="cpu")
    assert list(t.bounds_epochs) == [1, 1, 0, 0] and t.summary == summary
    _state_equal(j, t)
    tw = TWriter(t)
    _all_paths_equal(j, t, jw, tw)
    # the port goes on from the carried epochs: its next remap is epoch 2
    for w in (jw, tw):
        w.schedule_resummarize(np.linspace(-1.0, 121.0, 33))
        w.flush()
    assert list(t.bounds_epochs) == list(j.bounds_epochs) == [2] * 4
    _state_equal(j, t)
    _all_paths_equal(j, t, jw, tw)
    del arrays["bounds_epochs"], arrays["summary"]
    plain = convert.from_arrays(arrays, device="cpu")
    assert list(plain.bounds_epochs) == [0] * 4
    assert plain.summary == "equal_mass"
    arrays["bounds_epochs"] = np.zeros(3)
    with pytest.raises(ValueError, match="bounds_epochs"):
        convert.from_arrays(arrays, device="cpu")
