"""Port parity: maintenance (§5) — eager and batched inserts (Algorithm 3),
lazy deletes, vacuum, re-summarization and the sync engine's writes.

The same seeded stream goes through the JAX package (on the CPU) and the
port (``device="cpu"``, where every kernel wrapper takes its plain
version). After it, every ``HippoState`` field, the per-shard summaries, the
table's columns and counters, ``MaintenanceCounters``, the engine's
write/delete counters and the compact, dense and single-query results must
be equal, refusals included (same message, same rollback).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bitmap as jbm
from repro.core import histogram as jhg
from repro.core import index as jix
from repro.core.hippo import HippoIndex as JHippo
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.runtime.engine import QueryEngine as JEngine
from repro.storage.table import PagedTable as JTable
from repro_torch import convert
from repro_torch.core import bitmap as tbm
from repro_torch.core import histogram as thg
from repro_torch.core import index as tix
from repro_torch.core.hippo import HippoIndex as THippo
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.runtime.engine import QueryEngine as TEngine
from repro_torch.storage.table import PagedTable as TTable

DAYS = 2555


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_equal(ref, got, what):
    a, b = np.asarray(ref), _host(got)
    if a.dtype == np.uint32:
        b = b.view(np.uint32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _assert_state_equal(js, ts):
    for f in jix.HippoState._fields:
        _assert_equal(getattr(js, f), getattr(ts, f), f)


def _assert_table_equal(jt, tt):
    for f in ("keys", "valid", "dirty"):
        _assert_equal(getattr(jt, f), getattr(tt, f), f"table.{f}")
    for f in ("num_pages", "fill", "num_dirty", "capacity_pages"):
        assert getattr(jt, f) == getattr(tt, f), f


def _assert_index_equal(j, t):
    if isinstance(j, JSharded):
        _assert_state_equal(j.state.shards, t.state.shards)
        _assert_equal(j.state.summaries, t.state.summaries, "summaries")
        assert j.summarized_until == t.summarized_until
    else:
        _assert_state_equal(j.state, t.state)
    _assert_table_equal(j.table, t.table)
    assert dataclasses.asdict(j.counters) == dataclasses.asdict(t.counters)


def _preds(seed: int, n: int = 8):
    rng = np.random.default_rng(seed)
    spans = [(float(lo), float(lo + w)) for lo, w in
             zip(rng.integers(0, DAYS, n), [0, 9, 99, 400] * n)]
    spans += [(5.0, 1.0), (-np.inf, np.inf), (DAYS + 10.0, DAYS + 20.0)]
    return ([JPred.between(*s) for s in spans],
            [TPred.between(*s) for s in spans])


def _assert_results_equal(jres, tres):
    for f in jres._fields:
        _assert_equal(getattr(jres, f), getattr(tres, f), f)


def _assert_queries_equal(j, t, seed=0):
    """Compact (a slab that truncates, the full cap, row ids), dense and,
    unsharded, every ``search`` field."""
    jp, tp = _preds(seed)
    for m, k in ((2, 4), (j.gather_cap, 8)):
        _assert_results_equal(j.search_compact_batch(jp, max_selected=m,
                                                     top_k=k),
                              t.search_compact_batch(tp, max_selected=m,
                                                     top_k=k))
    _assert_results_equal(j.search_batch(jp), t.search_batch(tp))
    if isinstance(j, JHippo):
        for a, b in zip(jp[:4], tp[:4]):
            _assert_results_equal(j.search(a), t.search(b))


def _pair(values, shards, h, page_card=8, spare_pages=64, **kw):
    """(reference, port) indexes over the same table: unsharded if
    ``shards`` is None."""
    jt = JTable.from_values(values, page_card, spare_pages=spare_pages)
    tt = TTable.from_values(values, page_card, spare_pages=spare_pages)
    if shards is None:
        return (JHippo.create(jt, resolution=h, **kw),
                THippo.create(tt, resolution=h, device="cpu", **kw))
    return (JSharded.create(jt, num_shards=shards, resolution=h, **kw),
            TSharded.create(tt, num_shards=shards, resolution=h,
                            device="cpu", **kw))


def _days(seed, n):
    return np.random.default_rng(seed).integers(0, DAYS, n).astype(np.float32)


def _raises_alike(jcall, tcall, match):
    """Both refuse with the same RuntimeError message."""
    with pytest.raises(RuntimeError, match=match) as je:
        jcall()
    with pytest.raises(RuntimeError, match=match) as te:
        tcall()
    assert str(je.value) == str(te.value)


LAYOUTS = [None, 3]           # unsharded HippoIndex, 3-shard index


# ---------------------------------------------------------------------------
# bitmap primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h", [16, 64, 400])
def test_bitmap_density_set_get_union_equal_reference(h):
    rng = np.random.default_rng(h)
    w = (rng.integers(0, 2**32, (5, jbm.num_words(h)), dtype=np.uint64)
         .astype(np.uint32))
    if h % 32:
        w[:, -1] &= np.uint32((1 << (h % 32)) - 1)
    tw = torch.from_numpy(w.view(np.int32).copy())
    _assert_equal(jbm.density(jnp.asarray(w), h), tbm.density(tw, h),
                  "density")
    for idx in sorted({0, 31, 32, h - 1} & set(range(h))):
        _assert_equal(jbm.set_bit(jnp.asarray(w), idx),
                      tbm.set_bit(tw, idx), f"set_bit {idx}")
        assert np.array_equal(np.asarray(jbm.get_bit(jnp.asarray(w), idx)),
                              tbm.get_bit(tw, idx).numpy())
    _assert_equal(jbm.union(jnp.asarray(w[:2]), jnp.asarray(w[2:4])),
                  tbm.union(tw[:2], tw[2:4]), "union")
    assert np.array_equal(np.bitwise_or.reduce(w, axis=0),
                          tbm.or_reduce(tw).numpy().view(np.uint32))
    assert tw.equal(torch.from_numpy(w.view(np.int32)))   # inputs untouched


# ---------------------------------------------------------------------------
# Algorithm 3: eager and batched inserts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", LAYOUTS)
@pytest.mark.parametrize("relocate", [True, False])
@pytest.mark.parametrize("h", [16, 64])
def test_eager_inserts_equal_reference(shards, relocate, h):
    # 2003 rows in 8-tuple pages: the last page is partial, so the stream
    # fills it (an existing page: bits set in place or relocated), then
    # opens pages that extend the last entry or create entries
    j, t = _pair(_days(h, 2003), shards, h, relocate_on_update=relocate)
    for v in _days(h + 1, 70):
        j.insert(float(v))
        t.insert(float(v))
    _assert_index_equal(j, t)
    assert j.counters.entries_created > 0
    if relocate:
        assert int(np.asarray(j.state.shards.num_slots
                              if shards else j.state.num_slots).sum()) > \
            j.num_entries
    _assert_queries_equal(j, t, seed=h)


@pytest.mark.parametrize("shards", LAYOUTS)
@pytest.mark.parametrize("relocate", [True, False])
@pytest.mark.parametrize("page_card", [8, 50])
def test_insert_batch_equals_reference(shards, relocate, page_card):
    # the batch spans the partial last page (the fused OR on summarized
    # pages) and new pages (the eager replay: extend, create, relocate)
    h = 64
    j, t = _pair(_days(1, 60 * page_card + 3), shards, h,
                 page_card=page_card, relocate_on_update=relocate)
    batch = _days(2, 9 * page_card + 5)
    j.insert_batch(batch)
    t.insert_batch(batch)
    _assert_index_equal(j, t)
    j.insert(17.0)                         # an eager insert between batches
    t.insert(17.0)
    batch = _days(3, 3 * page_card)
    j.insert_batch(batch)
    t.insert_batch(batch)
    _assert_index_equal(j, t)
    _assert_queries_equal(j, t, seed=page_card)


@pytest.mark.parametrize("relocate", [True, False])
def test_core_insert_paths_equal_reference(relocate):
    # the last entry's page, new pages, then pages of earlier entries (which
    # table appends never reach, but insert_tuple takes)
    j, t = _pair(_days(4, 1003), None, 64, relocate_on_update=relocate)
    jst, tst = j.state, t.state
    for v, p in ((5.0, 125), (2000.0, 125), (9.0, 126), (np.nan, 127),
                 (2500.0, 3), (1.0, 3), (700.0, 60), (3.0, 126)):
        jst = jix.insert_tuple(j.cfg, jst, jnp.float32(v), jnp.int32(p))
        tst = tix.insert_tuple(t.cfg, tst, v, p)
        _assert_state_equal(jst, tst)
    vals = _days(5, 40)
    pages = np.random.default_rng(5).integers(0, 127, 40).astype(np.int32)
    mask = np.arange(40) % 3 != 0
    jst = jix.insert_batch_existing(j.cfg, jst, jnp.asarray(vals),
                                    jnp.asarray(pages), jnp.asarray(mask))
    tst = tix.insert_batch_existing(t.cfg, tst, torch.from_numpy(vals),
                                    torch.from_numpy(pages),
                                    torch.from_numpy(mask))
    _assert_state_equal(jst, tst)
    _assert_state_equal(j.state, t.state)   # the inputs are untouched


@pytest.mark.parametrize("shards", LAYOUTS)
@pytest.mark.parametrize("kept,batch", [(4, False), (3, False), (4, True),
                                        (3, True)])
def test_density_boundary_extend_or_create(shards, kept, batch):
    # H=16, D=0.25: one full page whose tuples keep `kept` buckets. At 4
    # the last entry's density is exactly D (f32(4)/f32(16) == f32(0.25)),
    # not below it, so the next page creates an entry; at 3 it extends.
    hist = jhg.build_uniform(0.0, 160.0, 16)
    thist = thg.build_uniform(0.0, 160.0, 16, device="cpu")
    base = np.resize(np.arange(kept) * 10.0 + 5.0, 8).astype(np.float32)
    jt = JTable.from_values(base, 8, spare_pages=16)
    tt = TTable.from_values(base, 8, spare_pages=16)
    if shards is None:
        j = JHippo.create(jt, resolution=16, density=0.25, hist=hist)
        t = THippo.create(tt, resolution=16, density=0.25, device="cpu",
                          hist=thist)
    else:
        j = JSharded.create(jt, num_shards=shards, resolution=16,
                            density=0.25, hist=hist)
        t = TSharded.create(tt, num_shards=shards, resolution=16,
                            density=0.25, device="cpu",
                            hist=thist)
    new = np.full(3, 155.0, np.float32)
    if batch:
        j.insert_batch(new)
        t.insert_batch(new)
    else:
        for v in new:
            j.insert(float(v))
            t.insert(float(v))
    _assert_index_equal(j, t)
    assert j.num_entries == (2 if kept == 4 else 1)


@pytest.mark.parametrize("shards", LAYOUTS)
def test_capacity_refusal_at_the_same_tuple_rolls_back(shards):
    # few spare slots and relocation on: the batch is refused at the tuple
    # that needs a slot past max_slots; table and state roll back
    vals = np.linspace(0, DAYS - 1, 96).astype(np.float32)
    j, t = _pair(vals, shards, 16, max_slots=14, relocate_on_update=True)
    for v in np.linspace(0, DAYS - 1, 9):
        j.insert(float(v))
        t.insert(float(v))
    _assert_index_equal(j, t)
    batch = np.linspace(0, DAYS - 1, 300).astype(np.float32)
    _raises_alike(lambda: j.insert_batch(batch), lambda: t.insert_batch(batch),
                  "slot capacity")
    _assert_index_equal(j, t)
    # the eager path refuses before it touches the table
    with pytest.raises(RuntimeError, match="slot capacity"):
        for v in np.linspace(0, DAYS - 1, 500):
            j.insert(float(v))
    with pytest.raises(RuntimeError, match="slot capacity"):
        for v in np.linspace(0, DAYS - 1, 500):
            t.insert(float(v))
    _assert_index_equal(j, t)
    _assert_queries_equal(j, t)


def test_large_duplicate_batch_is_not_refused():
    # slots are charged at actual need: 1500 copies of one value fit in a
    # few slots although the worst case would not
    j, t = _pair(_days(8, 333), None, 64, relocate_on_update=True)
    batch = np.full(1500, 50.0, np.float32)
    j.insert_batch(batch)
    t.insert_batch(batch)
    _assert_index_equal(j, t)


def test_shard_layout_full_refusal_equals_reference():
    vals = _days(9, 400)
    j, t = _pair(vals, 2, 64, page_card=8, pages_per_shard=30)
    # 400 rows = 50 pages of 60 slab pages: 80 more rows fill the layout
    batch = _days(10, 85)
    _raises_alike(lambda: j.insert_batch(batch), lambda: t.insert_batch(batch),
                  "shard layout full")
    _assert_index_equal(j, t)
    for v in _days(11, 80):
        j.insert(float(v))
        t.insert(float(v))
    _assert_index_equal(j, t)
    _raises_alike(lambda: j.insert(1.0), lambda: t.insert(1.0),
                  "shard layout full")
    _assert_index_equal(j, t)


@pytest.mark.parametrize("shards", LAYOUTS)
def test_insert_into_empty_index(shards):
    # a zero-page build with the DBMS's histogram grows through Algorithm 3
    vals = [5.0, 50.0, 95.0, 12.0, 13.0] * 5
    for batch in (False, True):
        jt = JTable.from_values(np.zeros(0), page_card=8, spare_pages=64)
        tt = TTable.from_values(np.zeros(0), page_card=8, spare_pages=64)
        jh = jhg.build_uniform(0.0, 100.0, 32)
        th = thg.build_uniform(0.0, 100.0, 32, device="cpu")
        if shards is None:
            j = JHippo.create(jt, resolution=32, density=0.25, hist=jh)
            t = THippo.create(tt, resolution=32, density=0.25, hist=th,
                              device="cpu")
        else:
            j = JSharded.create(jt, num_shards=shards, resolution=32,
                                density=0.25, hist=jh)
            t = TSharded.create(tt, num_shards=shards, resolution=32,
                                density=0.25, hist=th, device="cpu")
        _assert_index_equal(j, t)
        if batch:
            j.insert_batch(np.asarray(vals))
            t.insert_batch(np.asarray(vals))
        else:
            for v in vals:
                j.insert(v)
                t.insert(v)
        _assert_index_equal(j, t)
        assert t.num_entries >= 1
        _assert_queries_equal(j, t)


# ---------------------------------------------------------------------------
# §5.2: lazy deletes and vacuum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", LAYOUTS)
@pytest.mark.parametrize("relocate", [True, False])
def test_delete_then_vacuum_equals_reference(shards, relocate):
    j, t = _pair(_days(12, 3001), shards, 64, relocate_on_update=relocate)
    for v in _days(13, 40):                # relocated and created entries
        j.insert(float(v))
        t.insert(float(v))
    for lo, hi in ((100.0, 300.0), (1500.0, 1500.0)):
        assert j.table.delete_where(lo, hi) == t.table.delete_where(lo, hi)
        _assert_index_equal(j, t)          # dirty notes, before the vacuum
        _assert_queries_equal(j, t)        # exact before the vacuum too
        assert j.vacuum() == t.vacuum()
        _assert_index_equal(j, t)
        _assert_queries_equal(j, t, seed=1)
    assert t.vacuum() == j.vacuum() == 0   # nothing dirty is left
    assert t.counters.entries_resummarized > 0


def test_vacuum_shard_leaves_other_shards_untouched():
    j, t = _pair(_days(14, 3000), 4, 64)
    assert j.table.delete_where(0.0, 200.0) == t.table.delete_where(0.0, 200.0)
    before = [tix.shard_state(t.state.shards, s) for s in range(4)]
    before = [tix.HippoState(*(f.clone() for f in st)) for st in before]
    summaries = t.state.summaries.clone()
    assert j.vacuum_shard(1) == t.vacuum_shard(1) > 0
    _assert_index_equal(j, t)
    for s in (0, 2, 3):
        _assert_state_equal(before[s], tix.shard_state(t.state.shards, s))
        assert torch.equal(summaries[s], t.state.summaries[s])
    left = list(t.dirty_shards())
    assert left == list(j.dirty_shards()) and 0 in left and 1 not in left
    assert j.vacuum() == t.vacuum()
    _assert_index_equal(j, t)
    assert list(t.dirty_shards()) == []
    _assert_queries_equal(j, t)


def test_resummarize_shard_onto_new_bounds_equals_reference():
    j, t = _pair(_days(15, 3000), 2, 64)
    j.table.delete_where(10.0, 90.0)
    t.table.delete_where(10.0, 90.0)
    new_j = jhg.build_uniform(0.0, 3000.0, 64).bounds
    new_t = thg.build_uniform(0.0, 3000.0, 64, device="cpu").bounds
    jk, jv = j._slabs()
    tk, tv = t._slabs()
    for s in range(2):
        js = jix.resummarize_shard(j.cfg, jix.HippoState(
            *(f[s] for f in j.state.shards)), jk[s], jv[s], new_j)
        ts = tix.resummarize_shard(t.cfg, tix.shard_state(t.state.shards, s),
                                   tk[s], tv[s], new_t)
        _assert_state_equal(js, ts)


def test_reference_with_pending_deletes_carried_in_vacuums_equal():
    # the table's dirty notes travel through convert; the port's vacuum of
    # the carried index reaches the reference's state
    j, _ = _pair(_days(16, 4000), 3, 64)
    for v in _days(17, 30):
        j.insert(float(v))
    j.table.delete_where(700.0, 900.0)
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
                  dirty=j.table.dirty, num_dirty=j.table.num_dirty)
    t = convert.from_arrays(arrays, device="cpu")
    t.counters = dataclasses.replace(j.counters)
    _assert_index_equal(j, t)
    assert j.vacuum() == t.vacuum() > 0
    _assert_index_equal(j, t)
    _assert_queries_equal(j, t)
    # without the notes the table is clean and nothing is vacuumed
    del arrays["dirty"], arrays["num_dirty"]
    clean = convert.from_arrays(arrays, device="cpu")
    assert clean.table.num_dirty == 0 and clean.vacuum() == 0


# ---------------------------------------------------------------------------
# The engine's writes under drain_policy="sync"
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", LAYOUTS)
def test_sync_engine_write_delete_equals_reference(shards):
    j, t = _pair(_days(18, 2500), shards, 64)
    je = JEngine(j, batch=16, drain_policy="sync")
    te = TEngine(t, batch=16, drain_policy="sync")
    for v in _days(19, 50):
        je.write(float(v))
        te.write(float(v))
    for lo, hi in ((30.0, 60.0), (5000.0, 6000.0), (900.0, 900.0)):
        assert je.delete(lo, hi) == te.delete(lo, hi)
    assert je.flush() == te.flush() == 0
    for f in ("writes", "deletes"):
        assert getattr(je.stats, f) == getattr(te.stats, f)
    _assert_index_equal(j, t)
    jp, tp = _preds(20)
    assert list(je.run_all(jp)) == list(te.run_all(tp))
    with pytest.raises(RuntimeError, match="writer-backed"):
        je.resummarize()
    with pytest.raises(RuntimeError, match="writer-backed"):
        te.resummarize()


@pytest.mark.parametrize("policy", [None, "between_batches", "on_depth",
                                    "manual"])
def test_writer_backed_policies_refuse(policy):
    # the reference gives these a MaintenanceWriter, and so does the port:
    # the same writes, delete, flush and resummarize leave the same state,
    # table, counters and answers (the writer's own parity is
    # tests/test_torch_writer.py)
    j, t = _pair(_days(21, 600), 2, 16)
    je = JEngine(j, drain_policy=policy, drain_depth=8)
    te = TEngine(t, drain_policy=policy, drain_depth=8)
    assert te.drain_policy == je.drain_policy == (policy or "between_batches")
    assert te.writer is not None and t.staging is te.writer
    for v in _days(22, 12):
        je.write(float(v))
        te.write(float(v))
    assert je.delete(0.0, 100.0) == te.delete(0.0, 100.0) > 0
    jp, tp = _preds(23)
    assert list(je.run_all(jp)) == list(te.run_all(tp))
    assert je.flush() == te.flush()
    assert je.resummarize(np.linspace(-1.0, 2600.0, 17)) == \
        te.resummarize(np.linspace(-1.0, 2600.0, 17)) == 2
    for f in ("writes", "deletes", "drains", "drained_rows", "resummarizes",
              "queue_depth", "staged_rows"):
        assert getattr(je.stats, f) == getattr(te.stats, f), f
    assert te.stats.writes == 12 and te.writer.pending_units == 0
    _assert_index_equal(j, t)
    _assert_queries_equal(j, t, seed=24)
