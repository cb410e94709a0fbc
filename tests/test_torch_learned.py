"""Port parity: learned summaries (``repro_torch.core.learned``).

The piecewise-linear CDF fit, the mass clamp, the materialized bounds and
the learned drift refit must equal the reference's bit for bit on the same
seeded samples (zipf(1.3), lognormal(0, 1.5), duplicate-heavy and
large-magnitude keys, degenerate samples that fall back to equal mass). A
learned ``ShardedHippoIndex`` must get the reference's bounds, and its
counts must equal the reference's and brute force on the compact, fused
and routed paths, with rows staged and not, through a learned refit.
"""
import numpy as np
import pytest
import torch

from repro.core import histogram as jhg
from repro.core import learned as jln
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.runtime.engine import QueryEngine as JEngine
from repro.storage.table import PagedTable as JTable
from repro_torch.core import histogram as thg
from repro_torch.core import learned as tln
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.runtime.engine import QueryEngine as TEngine
from repro_torch.storage.table import PagedTable as TTable


def _samples():
    rng = np.random.default_rng(0)
    return {
        "zipf": rng.zipf(1.3, 20_000).astype(np.float32),
        "lognormal": rng.lognormal(0.0, 1.5, 20_000).astype(np.float32),
        "ties": rng.choice(np.asarray([3.0, 7.0, 9.5], np.float32), 500),
        "large": (1e9 + rng.uniform(0, 1e4, 5000)).astype(np.float32),
        "tiny": np.asarray([1.0, 1.0, 1.0, 2.0], np.float32),
    }


def _bounds_equal(jh, th):
    a = np.asarray(jh.bounds)
    b = th.bounds.cpu().numpy()
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert np.array_equal(a.view(np.uint32), b.view(np.uint32))


def _models_equal(jm, tm):
    if jm is None:
        assert tm is None
        return
    for f in ("knots_x", "knots_y"):
        assert np.array_equal(getattr(jm, f), getattr(tm, f)), f
    assert (jm.n_knots, jm.segments, jm.max_error, jm.used_segments) == \
        (tm.n_knots, tm.segments, tm.max_error, tm.used_segments)


@pytest.mark.parametrize("name", sorted(_samples()))
@pytest.mark.parametrize("clamp", [None, 1 / 64])
def test_fit_cdf_and_boundaries_bit_equal(name, clamp):
    sample = _samples()[name]
    for segments in (4, 64):
        jm = jln.fit_cdf(sample, segments=segments, mass_clamp=clamp)
        tm = tln.fit_cdf(sample, segments=segments, mass_clamp=clamp)
        _models_equal(jm, tm)
        xs = np.linspace(sample.min() - 1, sample.max() + 1, 257)
        assert np.array_equal(jm.cdf(xs), tm.cdf(xs))
        for h in (8, 64, 400):
            _bounds_equal(jln.boundaries(jm, h),
                          tln.boundaries(tm, h, device="cpu"))


def test_weighted_points_and_clamp_masses_equal():
    rng = np.random.default_rng(1)
    x = rng.choice(np.arange(40, dtype=np.float32), 3000)
    w = rng.uniform(0.1, 2.0, 3000)
    for weights in (None, w):
        for clamp in (None, 1 / 400, 1 / 16, 0.5):
            for a, b in zip(jln._weighted_cdf_points(x, weights, clamp),
                            tln._weighted_cdf_points(x, weights, clamp)):
                assert np.array_equal(a, b)
    for mass, clamp in ((np.asarray([0.6, 0.2, 0.1, 0.05, 0.05]), 0.25),
                        (np.full(8, 0.125), 0.25), (np.asarray([0.9, 0.1]),
                                                    0.05),
                        (rng.dirichlet(np.full(50, 0.2)), 1 / 40)):
        assert np.array_equal(jln._clamp_masses(mass, clamp),
                              tln._clamp_masses(mass, clamp))


def test_greedy_knots_equal():
    rng = np.random.default_rng(2)
    x = np.sort(rng.uniform(0, 100, 400))
    y = np.cumsum(rng.uniform(0, 1, 400))
    y /= y[-1]
    for eps in (0.0, 1e-3, 0.02, 0.3):
        assert jln._greedy_knots(x, y, eps) == tln._greedy_knots(x, y, eps)


@pytest.mark.parametrize("name", sorted(_samples()) + ["constant"])
def test_build_histogram_bit_equal_including_fallback(name):
    sample = _samples().get(name, np.full(100, 7.0, np.float32))
    for h in (8, 64, 400):
        jh, jm = jln.build_histogram(sample, h)
        th, tm = tln.build_histogram(sample, h, device="cpu")
        _bounds_equal(jh, th)
        _models_equal(jm, tm)
        assert (tm is None) == (name == "constant")


def test_learned_rebuild_bit_equal():
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 1e5, 65536).astype(np.float32)
    jbase, tbase = jhg.build(base, 100), thg.build(base, 100, device="cpu")
    for res in (rng.uniform(3e5, 3.1e5, 4096).astype(np.float32),
                rng.choice(np.asarray([5.0, 6.0], np.float32), 300),
                np.full(64, 2e5, np.float32)):
        for kw in ({}, {"resolution": 64}, {"old_mass": 0.5},
                   {"segments": 8}):
            jh, jm = jln.learned_rebuild(jbase, res, **kw)
            th, tm = tln.learned_rebuild(tbase, res, **kw)
            _bounds_equal(jh, th)
            _models_equal(jm, tm)
            assert th.bounds.device == tbase.bounds.device


def test_refusals_alike():
    base = (jhg.build_uniform(0.0, 100.0, 8),
            thg.build_uniform(0.0, 100.0, 8, device="cpu"))
    cases = [
        (lambda m: m.fit_cdf(np.full(100, 3.0, np.float32)), "distinct"),
        (lambda m: m.fit_cdf(np.zeros(0, np.float32)), "distinct"),
        (lambda m: m.fit_cdf(np.asarray([1.0, 2.0]), segments=0), "segments"),
        (lambda m: m.fit_cdf(np.asarray([1.0, 2.0]), np.asarray([1.0])),
         "weights shape"),
        (lambda m: m.fit_cdf(np.asarray([1.0, 2.0]), np.asarray([0.0, 0.0])),
         "positive total"),
        (lambda m: m.learned_rebuild(base[m is tln], np.zeros(0)),
         "non-empty"),
        (lambda m: m.learned_rebuild(base[m is tln], np.ones(3),
                                     old_mass=1.0), "old_mass"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match) as je:
            call(jln)
        with pytest.raises(ValueError, match=match) as te:
            call(tln)
        assert str(je.value) == str(te.value)
        assert type(je.value).__name__ == type(te.value).__name__


# ---------------------------------------------------------------------------
# A learned sharded index
# ---------------------------------------------------------------------------

def _preds(values):
    q = np.quantile(values, [0.1, 0.12, 0.5, 0.7, 0.02, 0.98])
    spans = [(5.0, 1.0), (float(values[len(values) // 2]),) * 2,
             (q[0], q[1]), (q[2], q[3]), (q[4], q[5]), (-1e30, 1e30),
             (105.0, 112.0), (20.0, 20.0), (50.0, 50.0)]
    spans = [(float(a), float(b)) for a, b in spans]
    return [JPred.between(*s) for s in spans], [TPred.between(*s) for s in spans]


def _brute(table, tp, pending) -> np.ndarray:
    live = table.valid[: table.num_pages]
    keys = table.keys[: table.num_pages]
    return np.asarray([int((live & (keys >= p.lo) & (keys <= p.hi)).sum())
                       + int(((pending >= p.lo) & (pending <= p.hi)).sum())
                       for p in tp])


@pytest.mark.parametrize("num_shards", [1, 4])
@pytest.mark.parametrize("staged", [False, True])
def test_learned_index_bounds_and_counts_equal(num_shards, staged):
    rng = np.random.default_rng(5 * num_shards + staged)
    base = np.sort(np.concatenate([
        rng.uniform(0, 100, 240),
        rng.choice(np.asarray([20.0, 50.0], np.float32), 60)])
    ).astype(np.float32)
    j = JSharded.create(JTable.from_values(base, 8, spare_pages=256),
                        num_shards=num_shards, resolution=32, density=0.25,
                        summary="learned")
    t = TSharded.create(TTable.from_values(base, 8, spare_pages=256),
                        num_shards=num_shards, resolution=32, density=0.25,
                        summary="learned", device="cpu")
    assert t.summary == "learned"
    _bounds_equal(jhg.Histogram(j.state.shards.bounds[0]),
                  thg.Histogram(t.state.shards.bounds[0]))
    for a, b in zip(j.summary_models, t.summary_models):
        _models_equal(a, b)
    kw = dict(batch=8, drain_policy="manual", auto_resummarize=False)
    je, te = JEngine(j, **kw), TEngine(t, **kw)
    for v in rng.uniform(100, 130, 48):
        je.write(float(v))
        te.write(float(v))
    assert je.flush() == te.flush() == 48
    pending = (rng.uniform(125, 140, 12) if staged else np.zeros(0)
               ).astype(np.float32)
    for v in pending:
        je.write(float(v))
        te.write(float(v))
    jp, tp = _preds(base)

    def all_paths(msg):
        want = _brute(t.table, tp, pending)
        jr = JEngine(j, batch=8, mode="dense", drain_policy="manual",
                     writer=je.writer)
        tr = TEngine(t, batch=8, mode="dense", drain_policy="manual",
                     writer=te.writer)
        for got, ref in ((te.run_all(tp), je.run_all(jp)),
                         (t.search_batch(tp).counts.numpy(),
                          np.asarray(j.search_batch(jp).counts)),
                         (tr.run_all(tp), jr.run_all(jp))):
            assert np.array_equal(got, ref), msg
            assert np.array_equal(got, want), msg

    all_paths("learned build-time bounds")
    jh = je.writer.schedule_resummarize()
    th = te.writer.schedule_resummarize()
    _bounds_equal(jh, th)
    assert te.writer.stats.learned_refits == 1
    _models_equal(je.writer._pending_model, te.writer._pending_model)
    assert je.writer.drain(num_shards) == te.writer.drain(num_shards) == 0
    assert list(t.bounds_epochs) == list(j.bounds_epochs) == [1] * num_shards
    for a, b in zip(j.summary_models, t.summary_models):
        _models_equal(a, b)
    for f in ("bounds", "bitmaps", "num_slots"):
        assert np.array_equal(np.asarray(getattr(j.state.shards, f)).view(
            np.int32), getattr(t.state.shards, f).numpy().view(np.int32)), f
    all_paths("after the learned refit, rows still staged")
    assert je.flush() == te.flush() == pending.size
    pending = np.zeros(0, np.float32)
    all_paths("after the refit and the drain")


def test_engine_summary_knob_and_fallback_equal(monkeypatch):
    rng = np.random.default_rng(23)
    vals = np.sort(rng.uniform(0, 100, 300)).astype(np.float32)
    for index_policy, engine_policy in (("equal_mass", "learned"),
                                        ("learned", "equal_mass")):
        j = JSharded.create(JTable.from_values(vals, 8, spare_pages=64),
                            resolution=32, summary=index_policy)
        t = TSharded.create(TTable.from_values(vals, 8, spare_pages=64),
                            resolution=32, summary=index_policy, device="cpu")
        kw = dict(batch=8, drain_policy="manual", auto_resummarize=False,
                  summary=engine_policy)
        je, te = JEngine(j, **kw), TEngine(t, **kw)
        for v in rng.uniform(100, 120, 32):
            je.write(float(v))
            te.write(float(v))
        assert je.resummarize() == te.resummarize() == 4
        assert (je.stats.learned_refits, je.stats.learned_fallbacks) == \
            (te.stats.learned_refits, te.stats.learned_fallbacks)
        assert te.stats.learned_refits == (engine_policy == "learned")
        for a, b in zip(j.summary_models, t.summary_models):
            _models_equal(a, b)
        assert np.array_equal(np.asarray(j.state.shards.bounds),
                              t.state.shards.bounds.numpy())
    # a degenerate refit falls back to equal mass and counts a fallback
    from repro.runtime import writer as jwriter
    from repro_torch.runtime import writer as twriter
    monkeypatch.setattr(jwriter.ln, "learned_rebuild",
                        lambda h, s, *a, **k: (jhg.rebuild(h, s), None))
    monkeypatch.setattr(twriter.ln, "learned_rebuild",
                        lambda h, s, *a, **k: (thg.rebuild(h, s), None))
    for w in (je.writer, te.writer):
        w.write(130.0)
        w.schedule_resummarize(policy="learned")
        w.flush()
    assert (je.writer.stats.learned_fallbacks
            == te.writer.stats.learned_fallbacks == 1)
    assert all(m is None for m in t.summary_models)
    assert np.array_equal(np.asarray(j.state.shards.bitmaps),
                          t.state.shards.bitmaps.numpy().view(np.uint32))
    with pytest.raises(ValueError, match="summary"):
        TSharded.create(t.table, summary="nope", device="cpu")
    with pytest.raises(ValueError, match="policy"):
        te.writer.schedule_resummarize(policy="nope")
    assert torch.equal(t.state.shards.bounds[0], t.state.shards.bounds[3])
