"""Port parity: index build and the compact batch search.

The same seeded key column goes through ``repro.core.partition`` (JAX, on
the CPU) and ``repro_torch.core.partition`` (PyTorch, ``device="cpu"``,
where every kernel wrapper takes its plain version). Every ``HippoState``
array, the per-shard summaries, the query bitmaps and all eight
``CompactBatchResult`` fields must be equal, including slabs small enough to
truncate and ``top_k > 0``. The last tests carry a reference-built state
(with relocated slots after inserts) into the port through
``repro_torch.convert`` and serve it.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import index as jix
from repro.core import partition as jpart
from repro.core import predicate as jpredicate
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.core.predicate import intervals as jintervals
from repro.storage.table import PagedTable as JTable
from repro_torch import convert
from repro_torch.core import index as tix
from repro_torch.core import partition as tpart
from repro_torch.core import predicate as tpredicate
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.storage.table import PagedTable as TTable

RESULT_FIELDS = jix.CompactBatchResult._fields


def _values(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "shipdate":
        return rng.integers(0, 2555, n).astype(np.float32)
    if kind == "sorted":
        return np.sort(rng.uniform(0, 1e6, n)).astype(np.float32)
    if kind == "zipf":
        return np.minimum(rng.zipf(1.5, n), 5000).astype(np.float32)
    raise ValueError(kind)


def _both(values, num_shards, resolution, spare_pages=0):
    j = JSharded.create(JTable.from_values(values, 50, spare_pages=spare_pages),
                        num_shards=num_shards, resolution=resolution)
    t = TSharded.create(TTable.from_values(values, 50, spare_pages=spare_pages),
                        num_shards=num_shards, resolution=resolution,
                        device="cpu")
    return j, t


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(ref, got, what):
    a, b = np.asarray(ref), _host(got)
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _assert_state_equal(j, t):
    for f in jix.HippoState._fields:
        _assert_equal(getattr(j.state.shards, f), getattr(t.state.shards, f), f)
    _assert_equal(j.state.summaries, t.state.summaries, "summaries")


def _preds(seed: int, n: int = 12):
    rng = np.random.default_rng(seed)
    out = [(float(lo), float(lo + w)) for lo, w in
           zip(rng.integers(0, 2500, n), [0, 9, 99] * n)]
    out += [(5.0, 1.0), (-np.inf, np.inf), (3000.0, 4000.0), (-1e9, 3.0)]
    return ([JPred.between(*p) for p in out], [TPred.between(*p) for p in out])


def _assert_result_equal(jres, tres):
    for f in RESULT_FIELDS:
        _assert_equal(getattr(jres, f), getattr(tres, f), f)


@pytest.mark.parametrize("kind,n,shards,h", [("shipdate", 6000, 1, 400),
                                             ("shipdate", 6000, 4, 64),
                                             ("sorted", 5000, 3, 400),
                                             ("zipf", 4000, 3, 64)])
def test_build_state_and_summaries_equal_reference(kind, n, shards, h):
    j, t = _both(_values(kind, n, seed=n + h), shards, h)
    _assert_state_equal(j, t)
    assert t.num_entries == j.num_entries
    assert t.summarized_until == j.summarized_until
    assert t.gather_cap == j.gather_cap


@pytest.fixture(scope="module")
def shipdate_pair():
    return _both(_values("shipdate", 7000, seed=11), 3, 64)


def test_query_bitmaps_equal_reference(shipdate_pair):
    j, t = shipdate_pair
    jp, tp = _preds(1)
    _assert_equal(j._query_bitmaps(jp), t._query_bitmaps(tp)[0], "qbms")


def _bounds_rows(kind: str, h: int = 64) -> np.ndarray:
    """(4, H+1) stacked bounds: one row for every shard, two epochs (shard 0
    on a remap's new row after one drain unit), or four distinct rows."""
    rng = np.random.default_rng(h)
    rows = [np.cumsum(rng.random(h + 1) * 40 + 0.5).astype(np.float32) - 50
            for _ in range(4)]
    if kind == "equal":
        rows = [rows[0]] * 4
    elif kind == "two epochs":
        rows = [rows[1]] + [rows[0]] * 3
    return np.stack(rows)


def _conversion_preds(kind: str, bounds: np.ndarray) -> list:
    """Predicates of one kind; ``bit31`` and the ``q64``/``q256`` batches
    are drawn against the (S, H+1) ``bounds``."""
    nan, inf = float("nan"), float("inf")
    h = bounds.shape[1] - 1

    def mid(b):                # a key inside bucket b of row 0
        return float((bounds[0, b] + bounds[0, b + 1]) / 2)

    if kind == "bit31":        # runs that start, end or sit on bit 31
        pairs = [p for b in range(31, h, 32) for p in
                 [(mid(b), mid(b)), (mid(b - 1), mid(b)), (mid(0), mid(b)),
                  (mid(b), mid(min(b + 1, h - 1))), (mid(b), inf)]]
    elif kind in ("q64", "q256"):
        rng = np.random.default_rng(int(kind[1:]) + h)
        q = int(kind[1:])
        lo = rng.uniform(bounds.min() - 50, bounds.max() + 50, q)
        hi = lo + rng.choice([0.0, 1.0, 30.0, 365.0, -3.0], q)
        lo[0], hi[1], lo[2], hi[3] = nan, nan, -inf, inf
        lo[4], hi[4], lo[5], hi[5] = -inf, inf, nan, nan
        pairs = list(zip(lo.tolist(), hi.tolist()))
    else:
        pairs = {"q0": [], "q1": [(100.0, 900.0)],
                 "empty": [(5.0, 1.0), (3.0, 2.0), (1e9, -1e9)],
                 "edges": [(-np.inf, np.inf), (-np.inf, 0.0), (700.0, np.inf),
                           (nan, 10.0), (10.0, nan), (nan, nan), (5.0, 1.0),
                           (-1e9, -1e8), (1e8, 1e9), (12.5, 12.5),
                           (-3.4e38, 3.4e38), (0.0, 2000.0)]}[kind]
    return [TPred.between(lo, hi) for lo, hi in pairs]


def _check_sharded_conversion(rows_kind, preds_kind, h, monkeypatch):
    def no_unique(*a, **k):
        raise AssertionError("the conversion called torch.unique")
    bounds = _bounds_rows(rows_kind, h)
    preds = _conversion_preds(preds_kind, bounds)
    tb = torch.from_numpy(bounds)
    los, his, nonempty = tpredicate.upload_intervals(preds, "cpu")
    monkeypatch.setattr(torch, "unique", no_unique)
    got = tpredicate.interval_bitmaps_sharded(tb, los, his, nonempty)
    each = torch.stack([tpredicate.interval_bitmaps(tb[s], los, his, nonempty)
                        for s in range(tb.shape[0])])
    assert got.dtype == torch.int32 and torch.equal(got, each)
    assert got.shape == (4, len(preds), (h + 31) // 32)
    want = jpredicate.interval_bitmaps_sharded(
        jnp.asarray(bounds), jnp.asarray(los.numpy()),
        jnp.asarray(his.numpy()), jnp.asarray(nonempty.numpy()))
    _assert_equal(want, got, "qbms")
    assert np.array_equal(nonempty.numpy(), [not p.empty for p in preds])
    if preds_kind == "bit31":
        assert bool((got < 0).any())          # bit 31 is set somewhere


@pytest.mark.parametrize("preds_kind", ["edges", "empty", "q0", "q1",
                                        "bit31", "q64", "q256"])
@pytest.mark.parametrize("rows_kind", ["equal", "distinct", "two epochs"])
def test_sharded_conversion_equals_each_rows_own(rows_kind, preds_kind,
                                                 monkeypatch):
    """Row s of the sharded conversion is the batch converted under
    ``bounds[s]`` alone, and the reference's per-shard conversion, bit for
    bit, whether the shards share one bounds row or not; the conversion
    calls no ``torch.unique``."""
    _check_sharded_conversion(rows_kind, preds_kind, 64, monkeypatch)


@pytest.mark.parametrize("preds_kind", ["edges", "empty", "q0", "q1",
                                        "bit31", "q64", "q256"])
@pytest.mark.parametrize("rows_kind", ["equal", "distinct", "two epochs"])
@pytest.mark.parametrize("h", [32, 100, 400])
def test_sharded_conversion_at_each_width_equals_reference(h, rows_kind,
                                                           preds_kind,
                                                           monkeypatch):
    """The same at one word (H = 32), at a partial last word (H = 100: 4
    words, 4 bits in the last) and at the benchmark's H = 400 (13 words,
    16 bits in the last)."""
    _check_sharded_conversion(rows_kind, preds_kind, h, monkeypatch)


@pytest.mark.parametrize("method", ["search_compact_batch", "search_batch",
                                    "plan_batch"])
def test_sharded_batch_converts_with_one_upload(shipdate_pair, method,
                                                monkeypatch):
    """Each sharded batch uploads its endpoints once (``intervals`` and
    ``upload_intervals`` together called once) and calls no
    ``torch.unique``; its results equal the reference's."""
    j, t = shipdate_pair
    jp, tp = _preds(7)
    calls = []

    def counted(fn):
        def wrapper(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapper

    def no_unique(*a, **k):
        raise AssertionError("the conversion called torch.unique")
    monkeypatch.setattr(tpart, "intervals", counted(tpart.intervals))
    monkeypatch.setattr(tpart, "upload_intervals",
                        counted(tpart.upload_intervals))
    monkeypatch.setattr(torch, "unique", no_unique)
    kw = ({"max_selected": j.gather_cap, "top_k": 8}
          if method == "search_compact_batch" else {})
    got = getattr(t, method)(tp, **kw)
    assert calls == ["upload_intervals"]
    want = getattr(j, method)(jp, **kw)
    for w, g in zip(want, got):
        _assert_equal(w, g, method)


@pytest.mark.parametrize("max_selected,top_k", [(3, 0), (3, 8), (16, 0),
                                                (None, 8)])
def test_search_compact_many_sharded_equals_reference(shipdate_pair,
                                                      max_selected, top_k):
    j, t = shipdate_pair
    m = max_selected or j.gather_cap
    jp, tp = _preds(2)
    jres = j.search_compact_batch(jp, max_selected=m, top_k=top_k)
    tres = t.search_compact_batch(tp, max_selected=m, top_k=top_k)
    _assert_result_equal(jres, tres)
    if max_selected == 3:
        assert bool(np.asarray(jres.truncated).any())


def test_search_compact_many_unsharded_equals_reference():
    j, t = _both(_values("sorted", 4000, seed=5), 1, 400)
    jp, tp = _preds(3)
    jst = jpart.shard_state(j.state.shards, 0)
    tst = tix.HippoState(*(f[0] for f in t.state.shards))
    jq = j._query_bitmaps(jp)[0]
    tq, tlo, thi = t._query_bitmaps(tp)
    tq = tq[0]
    jlo, jhi = jintervals(jp)
    jk, jv = j._slabs()
    tk, tv = t._slabs()
    for m, k in ((4, 5), (64, 0)):
        jres = jix.search_compact_many(jst, jq, jk[0], jv[0], jlo, jhi,
                                       max_selected=m, top_k=k)
        tres = tix.search_compact_many(tst, tq, tk[0], tv[0], tlo, thi,
                                       max_selected=m, top_k=k)
        _assert_result_equal(jres, tres)


def test_search_compact_rejects_bad_widths(shipdate_pair):
    _, t = shipdate_pair
    _, tp = _preds(4)
    with pytest.raises(ValueError):
        t.search_compact_batch(tp, max_selected=0)
    with pytest.raises(ValueError):
        t.search_compact_batch(tp, max_selected=4, top_k=-1)


def _reference_arrays(j) -> dict:
    sh = j.state.shards
    arrays = {f: np.asarray(getattr(sh, f)) for f in jix.HippoState._fields}
    arrays["summaries"] = np.asarray(j.state.summaries)
    arrays.update(num_shards=j.spec.num_shards,
                  pages_per_shard=j.spec.pages_per_shard,
                  resolution=j.cfg.resolution, density=j.cfg.density,
                  page_card=j.cfg.page_card, max_slots=j.cfg.max_slots,
                  relocate_on_update=j.cfg.relocate_on_update,
                  keys=j.table.keys, valid=j.table.valid,
                  num_pages=j.table.num_pages, fill=j.table.fill)
    return arrays


def test_reference_state_carried_in_through_convert_serves_equal():
    values = _values("shipdate", 4020, seed=8)
    j = JSharded.create(JTable.from_values(values, 50, spare_pages=64),
                        num_shards=2, resolution=64)
    rng = np.random.default_rng(8)
    for v in rng.integers(0, 2555, 60):        # relocations + new pages
        j.insert(float(v))
    sh = j.state.shards
    assert not np.asarray(sh.slot_live)[:, : int(np.asarray(sh.num_slots).max())].all()
    t = convert.from_arrays(_reference_arrays(j), device="cpu")
    _assert_state_equal(j, t)
    jp, tp = _preds(6)
    _assert_equal(j._query_bitmaps(jp), t._query_bitmaps(tp)[0], "qbms")
    for m, k in ((2, 8), (j.gather_cap, 8), (8, 0)):
        _assert_result_equal(j.search_compact_batch(jp, max_selected=m, top_k=k),
                             t.search_compact_batch(tp, max_selected=m, top_k=k))


def test_convert_refuses_mismatched_capacity():
    j, _ = _both(_values("sorted", 1000, seed=1), 2, 64)
    arrays = _reference_arrays(j)
    arrays["max_slots"] += 1
    with pytest.raises(ValueError):
        convert.from_arrays(arrays, device="cpu")
