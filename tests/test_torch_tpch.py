"""Port parity: the TPC-H Lineitem workload (``repro_torch.storage.tpch``).

The port's generator gives the reference's columns bit for bit for a seed;
the shipdate index built by each package is the same state; Q6, Q15 and Q20
over the single-query ``search`` return the reference's answers, and the
same answers as over a brute-force scan's mask.
"""
import numpy as np
import pytest

from repro.core import index as jix
from repro.storage import tpch as jtpch
from repro_torch.storage import tpch as ttpch

CARD = 30_000


@pytest.fixture(scope="module")
def both():
    jli = jtpch.generate_lineitem(CARD, seed=3)
    tli = ttpch.generate_lineitem(CARD, seed=3)
    jidx = jtpch.build_shipdate_index(jli)
    tidx = ttpch.build_shipdate_index(tli, device="cpu")
    return jli, tli, jidx, tidx


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_lineitem_columns_equal_reference(seed):
    jli = jtpch.generate_lineitem(1000, seed=seed)
    tli = ttpch.generate_lineitem(1000, seed=seed)
    assert tli.card == jli.card == 1000
    for col in ("partkey", "shipdate", "discount", "quantity",
                "extendedprice", "suppkey"):
        a, b = getattr(jli, col), getattr(tli, col)
        assert a.dtype == b.dtype == np.float32
        assert np.array_equal(a.view(np.int32), b.view(np.int32)), col


def test_shipdate_index_equals_reference(both):
    _, _, jidx, tidx = both
    for f in jix.HippoState._fields:
        a, b = np.asarray(getattr(jidx.state, f)), getattr(tidx.state, f).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert np.array_equal(a, b), f
    assert tidx.table.capacity_pages == jidx.table.capacity_pages


@pytest.mark.parametrize("sf", [0.001, 0.01, 0.1])
def test_queries_equal_reference(both, sf):
    jli, tli, jidx, tidx = both
    lo, hi = ttpch.selectivity_window(sf)
    assert (lo, hi) == jtpch.selectivity_window(sf)
    assert ttpch.q6(tli, tidx, lo, hi) == jtpch.q6(jli, jidx, lo, hi)
    assert ttpch.q15(tli, tidx, lo, hi) == jtpch.q15(jli, jidx, lo, hi)
    assert ttpch.q20(tli, tidx, lo, hi) == jtpch.q20(jli, jidx, lo, hi)


def test_queries_over_brute_force_mask(both):
    _, tli, _, tidx = both
    lo, hi = ttpch.selectivity_window(0.05)
    brute = (tli.shipdate >= np.float32(lo)) & (tli.shipdate <= np.float32(hi))
    assert ttpch.q6(tli, tidx, lo, hi) == ttpch.q6_over(tli, brute)
    assert ttpch.q15(tli, tidx, lo, hi) == ttpch.q15_over(tli, brute)
    assert ttpch.q20(tli, tidx, lo, hi) == ttpch.q20_over(tli, brute)
