"""Parity of the port's comparison baselines with the reference's, on the CPU.

The B+-tree (``repro_torch.core.baselines.btree``), the min-max index and the
full scan take the same seeded numpy inputs as the reference's
(``repro.core.baselines``) and must give equal results, with no tolerance:
the tree's structure (leaves in chain order with their keys and tids, the
separators of every level, the height), its I/O counters and ``nbytes``
after any stream of inserts, deletes and searches; min-max mins, maxs,
counts and pages inspected; full-scan counts. Run:

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q tests/test_torch_baselines.py
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.baselines import BPlusTree as RefTree
from repro.core.baselines import FullScan as RefScan
from repro.core.baselines import MinMaxIndex as RefMinMax
from repro_torch import convert
from repro_torch.core.baselines import BPlusTree, FullScan, MinMaxIndex
from repro_torch.storage.table import PagedTable

CPU = "cpu"


def ref_structure(tree) -> tuple[list, list]:
    """The reference tree's separators per level (root first, nodes left to
    right) and its leaves along ``next``, as (keys f64, tids i64)."""
    internal, nodes = [], [tree.root]
    while not nodes[0].leaf:
        internal.append([np.asarray(n.keys, np.float64) for n in nodes])
        nodes = [c for n in nodes for c in n.children]
    leaves, node = [], nodes[0]
    while node is not None:
        leaves.append((np.asarray(node.keys, np.float64),
                       np.asarray(node.ptrs, np.int64)))
        node = node.next
    return internal, leaves


def assert_same_tree(ref, port) -> None:
    internal, leaves = ref_structure(ref)
    got = port.structure()
    assert port.height == len(internal) + 1
    assert len(got["internal"]) == len(internal)
    for want_level, got_level in zip(internal, got["internal"]):
        assert len(got_level) == len(want_level)
        for w, g in zip(want_level, got_level):
            assert np.array_equal(w.view(np.int64), g.view(np.int64)), (w, g)
    assert len(got["leaves"]) == len(leaves)
    for (wk, wt), (gk, gt) in zip(leaves, got["leaves"]):
        # bit equality: -0.0, +0.0 and NaN keys too
        assert np.array_equal(wk.view(np.int64), gk.view(np.int64)), (wk, gk)
        assert np.array_equal(wt, gt)
    # the leaf chain is the tree's left-to-right leaf order
    assert got["chain"] == got["leaf_order"]
    assert (port.io.node_reads, port.io.node_writes, port.io.node_splits) == \
        (ref.io.node_reads, ref.io.node_writes, ref.io.node_splits)
    assert port.nbytes() == ref.nbytes()
    assert port.num_keys == ref.num_keys
    assert port.fanout == ref.fanout


def assert_same_search(ref, port, lo, hi) -> None:
    got = port.range_search(lo, hi)
    assert got.dtype == torch.int64 and got.dim() == 1
    assert got.tolist() == ref.range_search(lo, hi)
    assert port.count_range(lo, hi) == ref.count_range(lo, hi)
    assert port.io.node_reads == ref.io.node_reads


# -- B+-tree: bulk load ------------------------------------------------------

def _sizes(f):
    # empty, one key, one full leaf, one past it, three and four levels, and
    # sizes where the reference's bulk load raises (f**2 + 1: a level of
    # f + 1 leaves leaves a parent with no separator; f**3 + 1 one level up)
    return [0, 1, f, f + 1, 7 * f + 3, f * f * f // 2 + 3 * f, f * f + 1,
            f * f * f + 1, 3 * f * f + 7]


@pytest.mark.parametrize("fanout,n", [(f, n) for f in (4, 16)
                                      for n in _sizes(f)]
                         + [(256, n) for n in (0, 1, 256, 257, 5000,
                                               65537, 70000)])
def test_bulk_load_equals_reference(fanout, n):
    rng = np.random.default_rng(fanout * 1000 + n)
    values = rng.integers(0, max(2, n // 3), n).astype(np.float32)  # ties
    try:
        ref = RefTree.bulk_load(values, page_card=50, fanout=fanout)
    except IndexError:
        with pytest.raises(IndexError):
            BPlusTree.bulk_load(values, 50, fanout=fanout, device=CPU)
        return
    port = BPlusTree.bulk_load(values, 50, fanout=fanout, device=CPU)
    assert_same_tree(ref, port)
    for lo, hi in ((-1.0, 1e9), (0.0, 0.0), (2.5, 7.25), (5.0, 4.0)):
        assert_same_search(ref, port, lo, hi)
    assert_same_tree(ref, port)


def test_bulk_load_takes_a_tensor_and_float64_values():
    values = np.random.default_rng(3).uniform(0, 100, 999)   # float64
    ref = RefTree.bulk_load(values, page_card=50, fanout=16)
    assert_same_tree(ref, BPlusTree.bulk_load(values, 50, fanout=16,
                                              device=CPU))
    assert_same_tree(ref, BPlusTree.bulk_load(torch.from_numpy(values), 50,
                                              fanout=16, device=CPU))


def test_bulk_load_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BPlusTree.bulk_load(np.arange(10, dtype=np.float32), 50)


def test_nbytes_counts_keys_pointers_and_headers():
    """The reference's accounting from the fills: 12 B a leaf entry, 4 B a
    separator and 8 B a child, 16 B a node."""
    values = np.arange(5000, dtype=np.float32)
    port = BPlusTree.bulk_load(values, 50, fanout=32, device=CPU)
    leaves, l1, l2 = 157, 5, 1
    assert port.num_nodes() == (leaves, l1, l2)
    want = (12 * 5000 + 16 * leaves + 12 * (leaves - l1) + 24 * l1
            + 12 * (l1 - 1) + 24)
    assert port.nbytes() == want == RefTree.bulk_load(
        values, page_card=50, fanout=32).nbytes()


# -- B+-tree: streams of inserts, deletes and searches -------------------------

def _run_stream(ref, port, rng, steps: int, domain: int, tid0: int) -> None:
    for i in range(steps):
        op = rng.random()
        if op < 0.55:
            k = float(rng.integers(-2, domain + 2))
            if rng.random() < 0.2:
                k += 0.5
            ref.insert(k, tid0 + i)
            port.insert(k, tid0 + i)
        elif op < 0.75:
            k = float(rng.integers(-2, domain + 2))
            assert port.delete(k) == ref.delete(k)
        else:
            lo = float(rng.integers(-3, domain + 2)) - 0.25
            assert_same_search(ref, port, lo, lo + float(rng.integers(0, 9)))


@pytest.mark.parametrize("fanout,n,seed", [(4, 40, 0), (4, 0, 1), (4, 3, 2),
                                           (16, 700, 3), (16, 17, 4),
                                           (5, 60, 5), (256, 3000, 6),
                                           (3, 9, 7)])
def test_mixed_stream_equals_reference(fanout, n, seed):
    """Inserts (leaf splits, internal splits and root splits), deletes
    (duplicates across leaves included) and searches interleaved, with the
    whole structure compared every 100 steps."""
    rng = np.random.default_rng(seed)
    domain = 40
    values = rng.integers(0, domain, n).astype(np.float32)
    ref = RefTree.bulk_load(values, page_card=50, fanout=fanout)
    port = BPlusTree.bulk_load(values, 50, fanout=fanout, device=CPU)
    h0 = port.height
    for round_ in range(6):
        _run_stream(ref, port, rng, 100, domain, 10_000 * (round_ + 1))
        assert_same_tree(ref, port)
    assert ref.io.node_splits > 0
    assert port.height > h0 or fanout >= 16


def test_ascending_and_descending_inserts_split_at_the_ends():
    """Inserts that always land in the last leaf, then always in the first:
    root splits, chains relinked at both ends."""
    ref = RefTree.bulk_load(np.zeros(0, np.float32), page_card=50, fanout=4)
    port = BPlusTree.bulk_load(np.zeros(0, np.float32), 50, fanout=4,
                               device=CPU)
    for i in range(200):
        ref.insert(float(i), i)
        port.insert(float(i), i)
    for i in range(200):
        ref.insert(float(-i - 1), 1000 + i)
        port.insert(float(-i - 1), 1000 + i)
    assert_same_tree(ref, port)
    assert port.height >= 4
    for lo, hi in ((-300.0, 300.0), (-5.0, 5.0), (150.5, 151.0)):
        assert_same_search(ref, port, lo, hi)
    for k in range(-50, 50, 3):
        assert port.delete(float(k)) == ref.delete(float(k))
    assert_same_tree(ref, port)
    assert_same_search(ref, port, -300.0, 300.0)


def test_emptied_leaves_are_walked_through():
    """Deletes leave empty leaves in the chain (no rebalancing): a search
    walks through them, one read each, and stops after the first non-empty
    leaf whose last key is > hi."""
    values = np.arange(64, dtype=np.float32)
    ref = RefTree.bulk_load(values, page_card=50, fanout=4)
    port = BPlusTree.bulk_load(values, 50, fanout=4, device=CPU)
    for k in range(8, 40):
        assert port.delete(float(k)) == ref.delete(float(k))
    for lo, hi in ((5.0, 45.0), (8.0, 39.0), (9.0, 9.5), (38.0, 41.0),
                   (100.0, 200.0)):
        assert_same_search(ref, port, lo, hi)
    assert_same_tree(ref, port)


def test_delete_of_a_duplicate_in_an_earlier_leaf_returns_false():
    """The delete descends with side="right": for a key whose copies span
    leaves, the descent lands past the first copy's leaf. The reference then
    returns False where its chain still holds the key; the port too."""
    values = np.array([1, 2, 3, 5, 5, 5, 5, 5, 5, 5, 7, 8], np.float32)
    ref = RefTree.bulk_load(values, page_card=50, fanout=4)
    port = BPlusTree.bulk_load(values, 50, fanout=4, device=CPU)
    results = []
    for _ in range(8):
        r = ref.delete(5.0)
        assert port.delete(5.0) == r
        results.append(r)
    assert False in results and True in results
    assert_same_tree(ref, port)
    assert_same_search(ref, port, 5.0, 5.0)


def test_signed_zeros_nan_and_ties_equal_reference():
    """Stable order with -0.0/+0.0 mixed, NaN keys (sorted last), ties, and
    searches, inserts and deletes at those keys."""
    rng = np.random.default_rng(11)
    base = np.array([0.0, -0.0, np.nan, 1.0, -1.0, np.inf, -np.inf], np.float32)
    values = rng.choice(base, 300)
    values[::17] = -np.nan                    # a NaN with the sign bit set
    ref = RefTree.bulk_load(values, page_card=50, fanout=8)
    port = BPlusTree.bulk_load(values, 50, fanout=8, device=CPU)
    assert_same_tree(ref, port)
    for lo, hi in ((0.0, 0.0), (-0.0, -0.0), (-1.0, 1.0), (-np.inf, np.inf),
                   (np.nan, 1.0), (0.0, np.nan), (-np.inf, -np.inf)):
        assert_same_search(ref, port, lo, hi)
    for i, k in enumerate((0.0, -0.0, np.nan, 1.0, np.inf, -0.0, 0.5)):
        ref.insert(k, 900 + i)
        port.insert(k, 900 + i)
    for k in (-0.0, 0.0, np.nan, 0.5, 2.0, np.inf):
        assert port.delete(k) == ref.delete(k)
    assert_same_tree(ref, port)
    assert_same_search(ref, port, -np.inf, np.inf)


def test_inserted_keys_stay_float64():
    """``insert`` keeps float(key): after bulk-loading [0.1, 0.2, 0.3] as
    float32, inserting 0.1 puts it before the float32 0.1, and the float32
    leaf filter then returns both."""
    values = np.array([0.1, 0.2, 0.3], np.float32)
    ref = RefTree.bulk_load(values, page_card=50)
    port = BPlusTree.bulk_load(values, 50, device=CPU)
    ref.insert(0.1, 99)
    port.insert(0.1, 99)
    keys, tids = port.structure()["leaves"][0]
    assert keys.tolist() == [0.1, float(np.float32(0.1)),
                             float(np.float32(0.2)), float(np.float32(0.3))]
    assert tids.tolist() == [99, 0, 1, 2]
    assert port.range_search(0.1, 0.1).tolist() == [99, 0] == \
        ref.range_search(0.1, 0.1)
    assert_same_tree(ref, port)


def test_duplicates_of_lo_before_the_descents_leaf_are_lost_as_in_reference():
    """Pinned fault of the reference (ROADMAP.md queue 3): ``range_search``
    descends with side="right" on lo, so when the copies of a key lo span
    leaves, those in leaves before the descent's leaf are not returned. The
    port returns what the reference returns; a lower bound just below the
    key returns every copy."""
    values = np.repeat(np.arange(10, dtype=np.float32), 50)
    ref = RefTree.bulk_load(values, page_card=50, fanout=16)
    port = BPlusTree.bulk_load(values, 50, fanout=16, device=CPU)
    for lo, hi in ((3.0, 5.0), (0.0, 0.0), (7.0, 9.0)):
        brute = int(((values >= lo) & (values <= hi)).sum())
        assert_same_search(ref, port, lo, hi)
        assert port.count_range(lo, hi) == ref.count_range(lo, hi) < brute
        assert_same_search(ref, port, lo - 0.5, hi)
        assert port.count_range(lo - 0.5, hi) == brute == \
            ref.count_range(lo - 0.5, hi)
        tids = port.range_search(lo, hi).tolist()
        assert tids == ref.range_search(lo, hi)
        got = {(t >> 16) * 50 + (t & 0xFFFF) for t in tids}
        missed = set(np.flatnonzero((values >= lo) & (values <= hi))) - got
        assert missed and all(values[r] == lo for r in missed)


@pytest.mark.parametrize("lo,hi", [(0.1, 0.30000001), (1277.5000001, 1280.0),
                                   (np.float32(0.1), 0.2),
                                   (np.float64(0.1), np.float64(0.2)),
                                   (np.float32(0.2), np.float32(0.2))])
def test_bound_types_compare_as_numpy_does(lo, hi):
    """Python floats round to float32 in the leaf filter; numpy float64
    scalars keep float64 there; the stop test compares float64 keys."""
    values = np.array([0.1, 0.2, 0.3, 1277.5, 1278.0, 1280.0, 1281.0],
                      np.float32)
    ref = RefTree.bulk_load(values, page_card=50, fanout=4)
    port = BPlusTree.bulk_load(values, 50, fanout=4, device=CPU)
    ref.insert(0.2, 50)
    port.insert(0.2, 50)
    assert_same_search(ref, port, lo, hi)
    assert_same_tree(ref, port)


def test_btree_from_reference_then_the_same_stream():
    """A reference tree carried across continues as the reference does."""
    rng = np.random.default_rng(21)
    ref = RefTree.bulk_load(rng.integers(0, 30, 500).astype(np.float32),
                            page_card=50, fanout=8)
    for i in range(150):
        ref.insert(float(rng.integers(0, 30)), 5000 + i)
    ref.delete(3.0)
    ref.count_range(2.0, 9.0)
    port = convert.btree_from_reference(ref, device=CPU)
    assert_same_tree(ref, port)
    _run_stream(ref, port, rng, 300, 30, 20_000)
    assert_same_tree(ref, port)
    small = RefTree.bulk_load(np.array([2.0, 1.0], np.float32), page_card=50)
    assert_same_tree(small, convert.btree_from_reference(small, device=CPU))


# -- min-max -------------------------------------------------------------------

def _table(seed: int, num_values: int, page_card: int = 10):
    rng = np.random.default_rng(seed)
    values = rng.uniform(0, 100, num_values).astype(np.float32)
    table = PagedTable.from_values(values, page_card=page_card)
    valid = table.valid[: table.num_pages].copy()
    valid[rng.random(valid.shape) < 0.1] = False       # deleted tuples
    return table.keys[: table.num_pages].copy(), valid


@pytest.mark.parametrize("ppr", [1, 3, 7])
@pytest.mark.parametrize("num_values", [1000, 995, 61])
def test_minmax_equals_reference(ppr, num_values):
    """Ragged last ranges (pages % ppr != 0), a partial last page, invalid
    tuples, and a range with no valid tuple (+inf/-inf)."""
    keys, valid = _table(ppr * 7 + num_values, num_values)
    valid[2] = False
    ref = RefMinMax.build(jnp.asarray(keys), jnp.asarray(valid), ppr)
    port = MinMaxIndex.build(torch.from_numpy(keys), torch.from_numpy(valid),
                             ppr)
    assert np.array_equal(np.asarray(ref.mins).view(np.int32),
                          port.mins.numpy().view(np.int32))
    assert np.array_equal(np.asarray(ref.maxs).view(np.int32),
                          port.maxs.numpy().view(np.int32))
    assert port.nbytes() == ref.nbytes()
    rng = np.random.default_rng(ppr)
    for _ in range(20):
        lo = float(rng.uniform(-5, 105))
        hi = lo + float(rng.choice([0.0, 0.5, 3.0, 40.0]))
        want = ref.search(jnp.asarray(keys), jnp.asarray(valid), lo, hi)
        got = port.search(torch.from_numpy(keys), torch.from_numpy(valid),
                          lo, hi)
        assert [int(g) for g in got] == [int(w) for w in want]
        assert all(g.dtype == torch.int32 for g in got)


def test_minmax_nan_key_loses_its_range_as_the_reference_does():
    """Pinned fault of the reference (ROADMAP.md queue 3): a NaN key spreads
    NaN into its range's min and max, so the range is never inspected and a
    row that qualifies is lost. Full scan finds it."""
    keys = np.array([[1.0, np.nan, 5.0], [2.0, 3.0, 4.0]], np.float32)
    valid = np.ones((2, 3), bool)
    ref = RefMinMax.build(jnp.asarray(keys), jnp.asarray(valid))
    port = MinMaxIndex.build(torch.from_numpy(keys), torch.from_numpy(valid))
    assert bool(port.mins[0].isnan()) and bool(port.maxs[0].isnan())
    tk, tv = torch.from_numpy(keys), torch.from_numpy(valid)
    got = [int(x) for x in port.search(tk, tv, 4.5, 5.5)]
    want = [int(x) for x in ref.search(jnp.asarray(keys),
                                       jnp.asarray(valid), 4.5, 5.5)]
    assert got == want == [0, 0]
    assert int(FullScan.search(tk, tv, 4.5, 5.5)[0]) == 1 == int(
        RefScan.search(jnp.asarray(keys), jnp.asarray(valid), 4.5, 5.5)[0])


def test_minmax_from_arrays_searches_as_the_reference():
    keys, valid = _table(5, 700)
    ref = RefMinMax.build(jnp.asarray(keys), jnp.asarray(valid), 4)
    port = convert.minmax_from_arrays(np.asarray(ref.mins),
                                      np.asarray(ref.maxs), 4, device=CPU)
    for lo, hi in ((10.0, 12.0), (50.0, 50.5), (-1.0, 101.0)):
        got = port.search(torch.from_numpy(keys), torch.from_numpy(valid),
                          lo, hi)
        want = ref.search(jnp.asarray(keys), jnp.asarray(valid), lo, hi)
        assert [int(g) for g in got] == [int(w) for w in want]


# -- full scan -----------------------------------------------------------------

@pytest.mark.parametrize("lo,hi", [(0.1, 0.2), (1277.5000001, 1280.0),
                                   (1277.4999999, 1277.5),
                                   (np.float32(0.1), 0.30000001), (5, 5),
                                   (1280.0, 1277.0)])
def test_fullscan_rounds_bounds_to_float32(lo, hi):
    """Bounds float32 cannot hold compare as the reference's weak-typed
    scalars: rounded to float32 (1277.5000001 -> 1277.5 keeps 1277.5)."""
    values = np.array([0.1, 0.2, 0.3, 5.0, 1277.5, 1278.0, 1280.0, 0.0,
                       -0.0, 1277.4999], np.float32)
    table = PagedTable.from_values(values, page_card=4)
    keys = table.keys[: table.num_pages]
    valid = table.valid[: table.num_pages]
    got = FullScan.search(torch.from_numpy(keys), torch.from_numpy(valid),
                          lo, hi)
    want = RefScan.search(jnp.asarray(keys), jnp.asarray(valid), lo, hi)
    assert [int(g) for g in got] == [int(w) for w in want]
    assert got[0].dtype == torch.int32 and int(got[1]) == table.num_pages
    assert FullScan.nbytes() == RefScan.nbytes() == 0
