"""Port parity: the dense read paths and their kernels.

- The plain versions of kernels D (``batch_filter``, unsharded), E
  (``page_inspect`` and its batched ``page_inspect_many``) and F
  (``bitmap_and_any``) against the reference's Pallas kernels in interpret
  mode and their jnp refs, at ragged shapes, words with bit 31 set, empty
  intervals and all-zero queries.
- ``search_many_sharded`` (the fused dense batch), ``plan_batch`` and
  ``search_batch_shard_arrays`` (the routed surface) of a port-built
  ``ShardedHippoIndex`` against the reference's.
- The three dense engine paths — ``HippoIndex`` fused, ``ShardedHippoIndex``
  fused (``sharded=False``) and routed — against the reference's engine,
  ticket by ticket and ``EngineStats`` field by field, including a clustered
  column over 4 shards where routing prunes shards.

Every output is an integer, a bool or an f32 compare: equality, no
tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.hippo import HippoIndex as JHippo
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.kernels.batch_filter.ops import batch_filter as pallas_batch_filter
from repro.kernels.batch_filter.ref import batch_filter_ref as jnp_batch_filter
from repro.kernels.bitmap_and.ops import bitmap_and_any as pallas_bitmap_and
from repro.kernels.bitmap_and.ref import bitmap_and_any_ref as jnp_bitmap_and
from repro.kernels.page_inspect.ops import page_inspect as pallas_page_inspect
from repro.kernels.page_inspect.ref import page_inspect_ref as jnp_page_inspect
from repro.runtime.engine import QueryEngine as JEngine
from repro.storage.table import PagedTable as JTable
from repro_torch.core.hippo import HippoIndex as THippo
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.kernels.batch_filter import ops as bf_ops
from repro_torch.kernels.bitmap_and import ops as ba_ops
from repro_torch.kernels.page_inspect import ops as pi_ops
from repro_torch.runtime.engine import QueryEngine as TEngine
from repro_torch.storage.table import PagedTable as TTable

BIT31 = np.uint32(1 << 31)


def _words(rng, shape, density) -> np.ndarray:
    bits = rng.random((*shape, 32)) < density
    w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return w.astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# Kernel plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("q,e,w", [(1, 1, 1), (9, 130, 13), (17, 513, 2),
                                   (8, 64, 32), (17, 129, 16), (17, 257, 17),
                                   (17, 131, 32), (65, 3, 9)])
def test_batch_filter_plain_equals_pallas(q, e, w):
    rng = np.random.default_rng(q * 100 + e)
    qb = _words(rng, (q, w), 0.03)
    qb[::4] = 0                                  # all-zero queries
    qb[1::3, -1] |= BIT31
    ent = _words(rng, (e, w), 0.05)
    ent[::3, -1] = BIT31
    live = rng.random(e) < 0.75
    pallas = np.asarray(pallas_batch_filter(jnp.asarray(qb), jnp.asarray(ent),
                                            interpret=True)).astype(bool)
    assert np.array_equal(pallas,
                          np.asarray(jnp_batch_filter(qb, ent)).astype(bool))
    got = bf_ops.batch_filter(_t(qb), _t(ent), _t(live)).numpy()
    assert np.array_equal(got, pallas & live[None, :])
    everyone = bf_ops.batch_filter(_t(qb), _t(ent), torch.ones(e, dtype=bool))
    assert np.array_equal(everyone.numpy(), pallas)


@pytest.mark.parametrize("e,w", [(1, 1), (511, 13), (513, 13), (1000, 32)])
def test_bitmap_and_plain_equals_pallas(e, w):
    rng = np.random.default_rng(e + w)
    ent = _words(rng, (e, w), 0.05)
    ent[::3, -1] = BIT31
    live = rng.random(e) < 0.75
    for query in (_words(rng, (w,), 0.05), np.zeros(w, np.uint32),
                  np.full(w, BIT31, np.uint32)):
        pallas = np.asarray(pallas_bitmap_and(jnp.asarray(ent),
                                              jnp.asarray(query),
                                              interpret=True)).astype(bool)
        assert np.array_equal(pallas,
                              np.asarray(jnp_bitmap_and(ent, query)).astype(bool))
        got = ba_ops.bitmap_and_any(_t(ent), _t(query), _t(live)).numpy()
        assert np.array_equal(got, pallas & live)


def _table(rng, shape):
    keys = rng.integers(0, 100, shape).astype(np.float32)
    keys.reshape(-1)[::11] = np.float32(-3.4e38)
    valid = rng.random(shape) < 0.85
    return keys, valid


INTERVALS = [(10.0, 40.0), (50.0, 50.0), (30.0, 20.0), (-3.4e38, 3.4e38)]


@pytest.mark.parametrize("p,c", [(1, 50), (63, 50), (65, 7), (130, 1)])
def test_page_inspect_plain_equals_pallas(p, c):
    rng = np.random.default_rng(p * 10 + c)
    keys, valid = _table(rng, (p, c))
    mask = rng.random(p) < 0.6
    for lo, hi in INTERVALS:
        jq, jc = pallas_page_inspect(jnp.asarray(keys), jnp.asarray(valid),
                                     jnp.asarray(mask), lo, hi, interpret=True)
        rq, rc = jnp_page_inspect(jnp.asarray(keys), jnp.asarray(valid),
                                  jnp.asarray(mask), np.float32(lo),
                                  np.float32(hi))
        assert np.array_equal(np.asarray(jq), np.asarray(rq))
        assert np.array_equal(np.asarray(jc), np.asarray(rc))
        tq, tc = pi_ops.page_inspect(_t(keys), _t(valid), _t(mask), lo, hi)
        assert tq.dtype == torch.bool and tc.dtype == torch.int32
        assert np.array_equal(tq.numpy(), np.asarray(jq))
        assert np.array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("s,p,c,q", [(1, 40, 50, 1), (3, 70, 50, 9),
                                     (2, 5, 7, 65), (1, 129, 1, 4)])
def test_page_inspect_many_equals_a_loop_of_pallas(s, p, c, q):
    rng = np.random.default_rng(s * 1000 + p + q)
    keys, valid = _table(rng, (s, p, c))
    page_mask = rng.random((s, q, p)) < 0.7
    lo = rng.integers(0, 100, q).astype(np.float32)
    hi = (lo + rng.integers(-5, 30, q)).astype(np.float32)   # some empty
    got = pi_ops.page_inspect_many(_t(keys), _t(valid), _t(page_mask),
                                   _t(lo), _t(hi))
    assert got.dtype == torch.int32 and got.shape == (s, q)
    want = np.zeros((s, q), np.int32)
    for si in range(s):
        for qi in range(q):
            args = (jnp.asarray(keys[si]), jnp.asarray(valid[si]),
                    jnp.asarray(page_mask[si, qi]), lo[qi], hi[qi])
            # the Pallas kernel (interpret mode) for the first queries, its
            # jnp ref (checked equal above) for the rest
            _, counts = (pallas_page_inspect(*args, interpret=True) if qi < 2
                         else jnp_page_inspect(*args))
            want[si, qi] = int(np.asarray(counts).sum())
    assert np.array_equal(got.numpy(), want)


def test_kernel_wrappers_refuse_bad_inputs():
    e = torch.zeros((4, 13), dtype=torch.int32)
    with pytest.raises(TypeError):
        ba_ops.bitmap_and_any(e.float(), e[0], torch.ones(4, dtype=bool))
    with pytest.raises(ValueError):
        ba_ops.bitmap_and_any(e, e[0, :5], torch.ones(4, dtype=bool))
    with pytest.raises(ValueError):
        bf_ops.batch_filter(e[None], e, torch.ones(4, dtype=bool))
    keys = torch.zeros((3, 5))
    with pytest.raises(ValueError):
        pi_ops.page_inspect(keys, keys.bool(), torch.ones(4, dtype=bool), 0, 1)
    with pytest.raises(ValueError):
        pi_ops.page_inspect_many(keys[None], keys.bool()[None],
                                 torch.ones((1, 2, 3), dtype=bool),
                                 torch.zeros(3), torch.zeros(3))


# ---------------------------------------------------------------------------
# The sharded dense surface
# ---------------------------------------------------------------------------

def _values(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "shipdate":
        return rng.integers(0, 2555, n).astype(np.float32)
    if kind == "clustered":
        return np.sort(rng.integers(0, 2555, n)).astype(np.float32)
    raise ValueError(kind)


def _spans(seed: int, n: int):
    rng = np.random.default_rng(seed)
    spans = [(float(lo), float(lo + w)) for lo, w in
             zip(rng.integers(0, 2500, n), [0, 9, 99, 400] * n)]
    spans[min(3, n - 1)] = (7.0, 2.0)                   # empty predicate
    spans += [(-np.inf, np.inf), (3000.0, 4000.0)]
    return [JPred.between(*s) for s in spans], [TPred.between(*s) for s in spans]


@pytest.fixture(scope="module")
def sharded_pair():
    vals = _values("shipdate", 8000, seed=31)
    j = JSharded.create(JTable.from_values(vals, 50), num_shards=3,
                        resolution=64)
    t = TSharded.create(TTable.from_values(vals, 50), num_shards=3,
                        resolution=64, device="cpu")
    return j, t


def _assert_batch_equal(jres, tres):
    for f in jres._fields:
        a, b = np.asarray(getattr(jres, f)), _host(getattr(tres, f))
        assert a.shape == b.shape and a.dtype == b.dtype, f
        assert np.array_equal(a, b), f


def test_search_batch_fused_sharded_equals_reference(sharded_pair):
    j, t = sharded_pair
    jp, tp = _spans(5, 14)
    _assert_batch_equal(j.search_batch(jp), t.search_batch(tp))
    assert t.count(tp[0]) == j.count(jp[0])
    _assert_batch_equal(j.search(jp[1]), t.search(tp[1]))


def test_plan_batch_and_shard_arrays_equal_reference(sharded_pair):
    j, t = sharded_pair
    jp, tp = _spans(6, 10)
    jq, jlo, jhi, jmatch = j.plan_batch(jp)
    tq, tlo, thi, tmatch = t.plan_batch(tp)
    assert np.array_equal(jq, _host(tq).view(np.uint32))
    assert np.array_equal(jlo, _host(tlo)) and np.array_equal(jhi, _host(thi))
    assert tmatch.dtype == bool and np.array_equal(jmatch, tmatch)
    assert np.array_equal(t.shard_match_matrix(tp), jmatch)
    for s in range(j.num_shards):
        _assert_batch_equal(j.search_batch_shard_arrays(s, jq[s], jlo, jhi),
                            t.search_batch_shard_arrays(s, tq[s], tlo, thi))
        # a slice and padding of the converted rows, as the engine sends
        _assert_batch_equal(
            j.search_batch_shard_arrays(s, jq[s, 1:4], jlo[1:4], jhi[1:4]),
            t.search_batch_shard_arrays(s, tq[s, 1:4], tlo[1:4].contiguous(),
                                        thi[1:4].contiguous()))
        _assert_batch_equal(j.search_batch_shard(s, jp),
                            t.search_batch_shard(s, tp))


def test_sharded_introspection_equals_reference(sharded_pair):
    j, t = sharded_pair
    assert np.array_equal(j.shard_entry_counts(), t.shard_entry_counts())
    assert t.nbytes() == j.nbytes()
    assert t.nbytes(compressed=True) == j.nbytes(compressed=True)
    assert np.array_equal(np.asarray(j.histogram.bounds),
                          t.histogram.bounds.numpy())
    assert np.array_equal(np.asarray(j.shard_histogram(2).bounds),
                          t.shard_histogram(2).bounds.numpy())


# ---------------------------------------------------------------------------
# The three dense engine paths
# ---------------------------------------------------------------------------

STATS = ("submitted", "served", "batches", "slots_filled", "pad_slots",
         "shard_dispatches", "shards_pruned", "shard_queries", "shard_slots",
         "compact_batches", "compact_hits", "compact_fallbacks",
         "gather_union_pages", "gather_slab_pages", "selected_pages",
         "table_pages_seen")


def _run_both(jidx, tidx, jp, tp, **kw):
    je, te = JEngine(jidx, **kw), TEngine(tidx, **kw)
    assert te.mode == je.mode and te.sharded == je.sharded
    jt = [je.submit(p) for p in jp]
    tt = [te.submit(p) for p in tp]
    je.drain()
    te.drain()
    for a, b in zip(jt, tt):
        assert b.done and b.row_ids is None
        assert (a.qid, a.count, a.pages_inspected, a.entries_matched) == \
            (b.qid, b.count, b.pages_inspected, b.entries_matched)
    for f in STATS:
        assert getattr(je.stats, f) == getattr(te.stats, f), f
    assert je.stats.occupancy == te.stats.occupancy
    assert je.stats.shard_occupancy() == te.stats.shard_occupancy()
    return je, te


@pytest.fixture(scope="module")
def clustered_pair():
    vals = _values("clustered", 12000, seed=41)
    j = JSharded.create(JTable.from_values(vals, 50), num_shards=4,
                        resolution=64)
    t = TSharded.create(TTable.from_values(vals, 50), num_shards=4,
                        resolution=64, device="cpu")
    return j, t


@pytest.mark.parametrize("batch", [8, 5])
def test_routed_engine_equals_reference(sharded_pair, batch):
    j, t = sharded_pair
    jp, tp = _spans(batch, 23)
    _, te = _run_both(j, t, jp, tp, batch=batch, mode="dense")
    assert te.sharded and te.stats.shard_dispatches > 0


def test_routed_engine_prunes_clustered_shards_like_reference(clustered_pair):
    j, t = clustered_pair
    jp, tp = _spans(9, 30)
    _, te = _run_both(j, t, jp, tp, batch=8, sharded=True)
    assert te.mode == "dense" and te.stats.shards_pruned > 0


@pytest.mark.parametrize("batch", [8, 3])
def test_fused_sharded_engine_equals_reference(clustered_pair, batch):
    j, t = clustered_pair
    jp, tp = _spans(batch + 1, 17)
    _, te = _run_both(j, t, jp, tp, batch=batch, mode="dense", sharded=False)
    assert not te.sharded and te.stats.shard_dispatches == 0


@pytest.mark.parametrize("batch", [8, 6])
def test_fused_hippo_engine_equals_reference(batch):
    vals = _values("shipdate", 6000, seed=batch)
    j = JHippo.create(JTable.from_values(vals, 50), resolution=64)
    t = THippo.create(TTable.from_values(vals, 50), resolution=64,
                      device="cpu")
    jp, tp = _spans(batch + 2, 19)
    _run_both(j, t, jp, tp, batch=batch, mode="dense")
    # compact mode serves an unsharded index too
    _run_both(j, t, jp, tp, batch=batch, compact_bucket=4)


def test_dense_engines_agree_on_counts(clustered_pair):
    j, t = clustered_pair
    _, tp = _spans(3, 20)
    routed = TEngine(t, batch=8, mode="dense").run_all(tp)
    fused = TEngine(t, batch=8, mode="dense", sharded=False).run_all(tp)
    compact = TEngine(t, batch=8).run_all(tp)
    assert np.array_equal(routed, fused) and np.array_equal(routed, compact)


@pytest.mark.parametrize("kwargs", [{"mode": "dense", "top_k": 4},
                                    {"sharded": True, "top_k": 1},
                                    {"mode": "dense", "sharded": True,
                                     "unsharded": True},
                                    {"drain_policy": "between_batches",
                                     "unsharded": True}])
def test_dense_constructor_refusals_match_reference(sharded_pair, kwargs):
    j, t = sharded_pair
    if kwargs.pop("unsharded", False):
        vals = _values("shipdate", 500, seed=2)
        j = JHippo.create(JTable.from_values(vals, 50), resolution=16)
        t = THippo.create(TTable.from_values(vals, 50), resolution=16,
                          device="cpu")
    with pytest.raises(ValueError):
        JEngine(j, **kwargs)
    with pytest.raises(ValueError):
        TEngine(t, **kwargs)
