"""Port parity: the unsharded ``HippoIndex`` and the single-query search.

The same seeded key column goes through ``repro.core.hippo.HippoIndex`` (JAX,
on the CPU) and ``repro_torch.core.hippo.HippoIndex`` (``device="cpu"``,
where every kernel wrapper takes its plain version). The built states must
be equal first; then ``search`` (all five ``SearchResult`` fields),
``search_batch`` (``search_many``), ``search_compact`` and
``search_compact_batch``. The same searches run on reference-built states
carried in through ``repro_torch.convert``, one of them relocated by
reference inserts (``relocate_on_update=True``), unsharded and sharded
(``search_many_sharded``).
"""
import numpy as np
import pytest
import torch

from repro.core import index as jix
from repro.core.hippo import HippoIndex as JHippo
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.storage.table import PagedTable as JTable
from repro_torch import convert
from repro_torch.core import index as tix
from repro_torch.core.hippo import HippoIndex as THippo
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.core.predicate import matches
from repro_torch.storage.table import PagedTable as TTable


def _values(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "shipdate":
        return rng.integers(0, 2555, n).astype(np.float32)
    if kind == "sorted":
        return np.sort(rng.uniform(0, 1e6, n)).astype(np.float32)
    if kind == "zipf":
        return np.minimum(rng.zipf(1.5, n), 5000).astype(np.float32)
    raise ValueError(kind)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(ref, got, what):
    a, b = np.asarray(ref), _host(got)
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _assert_fields_equal(jres, tres):
    for f in jres._fields:
        _assert_equal(getattr(jres, f), getattr(tres, f), f)


def _assert_state_equal(js, ts):
    for f in jix.HippoState._fields:
        _assert_equal(getattr(js, f), getattr(ts, f), f)


def _preds(seed: int, hi: float = 2555.0, n: int = 9):
    rng = np.random.default_rng(seed)
    out = [(float(lo), float(lo + w)) for lo, w in
           zip(rng.uniform(0, hi, n).astype(np.float32),
               [0.0, hi / 250, hi / 25] * n)]
    out += [(5.0, 1.0), (-np.inf, np.inf), (hi + 10, hi + 20), (-1e9, 3.0)]
    return [JPred.between(*p) for p in out], [TPred.between(*p) for p in out]


def _both(values, resolution, spare_pages=0, **kw):
    j = JHippo.create(JTable.from_values(values, 50, spare_pages=spare_pages),
                      resolution=resolution, **kw)
    t = THippo.create(TTable.from_values(values, 50, spare_pages=spare_pages),
                      resolution=resolution, device="cpu", **kw)
    return j, t


CASES = [("shipdate", 6000, 400), ("sorted", 5000, 64), ("zipf", 4000, 64)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0])
def pair(request):
    kind, n, h = request.param
    j, t = _both(_values(kind, n, seed=n + h), h)
    hi = float(_values(kind, n, seed=n + h).max())
    return j, t, hi


def test_built_state_equals_reference(pair):
    j, t, _ = pair
    _assert_state_equal(j.state, t.state)
    assert t.num_entries == j.num_entries
    assert t.gather_cap == j.gather_cap
    assert t.nbytes() == j.nbytes()
    assert t.nbytes(compressed=True) == j.nbytes(compressed=True)
    for a, b in zip(j.entries_host(), t.entries_host()):
        _assert_equal(a, b, "entries_host")


def test_search_all_fields_equal_reference(pair):
    j, t, hi = pair
    jp, tp = _preds(1, hi)
    for a, b in zip(jp, tp):
        jres, tres = j.search(a), t.search(b)
        _assert_fields_equal(jres, tres)
        assert int(tres.count) == int(tres.qualified.sum())


def test_search_batch_equals_reference_and_search(pair):
    j, t, hi = pair
    jp, tp = _preds(2, hi)
    jres, tres = j.search_batch(jp), t.search_batch(tp)
    _assert_fields_equal(jres, tres)
    for q, p in enumerate(tp[:4]):
        one = t.search(p)
        assert int(one.count) == int(tres.counts[q])
        assert torch.equal(one.page_mask, tres.page_mask[q])


def test_search_compact_equals_reference(pair):
    j, t, hi = pair
    jp, tp = _preds(3, hi)
    for a, b in zip(jp, tp):
        for m in (None, 2, 17):
            want = j.search_compact(a, max_selected=m)
            got = t.search_compact(b, max_selected=m)
            for x, y in zip(want, got):
                _assert_equal(x, y, f"search_compact m={m}")


@pytest.mark.parametrize("m,top_k", [(3, 0), (3, 5), (None, 8)])
def test_search_compact_batch_equals_reference(pair, m, top_k):
    j, t, hi = pair
    jp, tp = _preds(4, hi)
    m = m or j.gather_cap
    _assert_fields_equal(j.search_compact_batch(jp, max_selected=m, top_k=top_k),
                         t.search_compact_batch(tp, max_selected=m,
                                                top_k=top_k))


def test_locate_slot_equals_reference(pair):
    j, t, _ = pair
    last = int(j.state.summarized_until)
    for page in sorted({0, 1, last // 3, last // 2, last}):
        js, jpos = jix.locate_slot(j.state, np.int32(page))
        ts, tpos = tix.locate_slot(t.state, page)
        assert (int(js), int(jpos)) == (int(ts), int(tpos))


def test_matches_is_the_exact_tuple_test():
    vals = torch.tensor([1.0, 2.0, 2.5, 3.0, np.inf])
    assert matches(TPred.between(2.0, 3.0), vals).tolist() == \
        [False, True, True, True, False]
    assert matches(TPred.greater(2.0), vals).tolist() == \
        [False, False, True, True, True]


def test_maintenance_refuses_until_ported():
    """Named for the refusals it checked before maintenance was ported: it
    now checks that insert, insert_batch and delete + vacuum run and leave
    the reference's state (tests/test_torch_maintenance.py covers the
    streams)."""
    j, t = _both(_values("shipdate", 600, seed=1), 16, spare_pages=4)
    for idx in (j, t):
        idx.insert(1.0)
        idx.insert_batch(np.ones(3, np.float32))
        idx.table.delete_where(0.0, 20.0)
        assert idx.vacuum() > 0
    _assert_state_equal(j.state, t.state)


def test_create_on_the_card_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid here")
    table = TTable.from_values(np.arange(500, dtype=np.float32), 50)
    with pytest.raises(RuntimeError, match="CUDA"):
        THippo.create(table)


# ---------------------------------------------------------------------------
# Reference-built states carried in through convert
# ---------------------------------------------------------------------------

def _config_arrays(j) -> dict:
    return dict(resolution=j.cfg.resolution, density=j.cfg.density,
                page_card=j.cfg.page_card, max_slots=j.cfg.max_slots,
                relocate_on_update=j.cfg.relocate_on_update,
                keys=j.table.keys, valid=j.table.valid,
                num_pages=j.table.num_pages, fill=j.table.fill)


def _relocated_reference() -> JHippo:
    j = JHippo.create(JTable.from_values(_values("shipdate", 3020, seed=8), 50,
                                         spare_pages=64),
                      resolution=64, relocate_on_update=True)
    for v in np.random.default_rng(8).integers(0, 2555, 70):
        j.insert(float(v))          # relocations + new pages
    return j


@pytest.mark.parametrize("relocated", [False, True])
def test_reference_state_carried_in_serves_equal(relocated):
    if relocated:
        j = _relocated_reference()
        st = j.state
        assert not np.asarray(st.slot_live)[: int(st.num_slots)].all()
    else:
        j = JHippo.create(JTable.from_values(_values("zipf", 3000, seed=9), 50),
                          resolution=64)
    arrays = {f: np.asarray(getattr(j.state, f))
              for f in jix.HippoState._fields}
    t = convert.hippo_index_from_arrays({**arrays, **_config_arrays(j)},
                                        device="cpu")
    _assert_state_equal(j.state, t.state)
    jp, tp = _preds(6)
    for a, b in zip(jp, tp):
        _assert_fields_equal(j.search(a), t.search(b))
    _assert_fields_equal(j.search_batch(jp), t.search_batch(tp))
    for m in (2, j.gather_cap):
        _assert_fields_equal(j.search_compact_batch(jp, max_selected=m, top_k=4),
                             t.search_compact_batch(tp, max_selected=m,
                                                    top_k=4))


def test_relocated_sharded_state_dense_batch_equals_reference():
    j = JSharded.create(JTable.from_values(_values("shipdate", 4020, seed=7),
                                           50, spare_pages=64),
                        num_shards=2, resolution=64)
    for v in np.random.default_rng(7).integers(0, 2555, 60):
        j.insert(float(v))
    sh = j.state.shards
    arrays = {f: np.asarray(getattr(sh, f)) for f in jix.HippoState._fields}
    arrays.update(_config_arrays(j), summaries=np.asarray(j.state.summaries),
                  num_shards=j.spec.num_shards,
                  pages_per_shard=j.spec.pages_per_shard)
    t = convert.from_arrays(arrays, device="cpu")
    jp, tp = _preds(7)
    _assert_fields_equal(j.search_batch(jp), t.search_batch(tp))
    jq, jlo, jhi, jm = j.plan_batch(jp)
    tq, tlo, thi, tm = t.plan_batch(tp)
    assert np.array_equal(jm, tm)
    for s in range(2):
        _assert_fields_equal(j.search_batch_shard_arrays(s, jq[s], jlo, jhi),
                             t.search_batch_shard_arrays(s, tq[s], tlo, thi))


def test_convert_refuses_mismatched_slots():
    j = JHippo.create(JTable.from_values(_values("sorted", 1000, seed=1), 50),
                      resolution=64)
    arrays = {f: np.asarray(getattr(j.state, f))
              for f in jix.HippoState._fields}
    conf = _config_arrays(j)
    conf["max_slots"] += 1
    with pytest.raises(ValueError):
        convert.hippo_index_from_arrays({**arrays, **conf}, device="cpu")
