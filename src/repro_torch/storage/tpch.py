"""TPC-H-style Lineitem workload (§7): generator + Q6/Q15/Q20 analogues
(port of ``repro.storage.tpch``).

The paper builds a Hippo index on Lineitem's ``l_shipdate`` and runs the
TPC-H queries that filter on it. The generator is the reference's numpy code
(the same columns, bit for bit, for a seed); dates are days since epoch,
uniform over 7 years. Each query reads the exact qualifying-tuple mask of
the single-query ``HippoIndex.search`` (moved to the host once per index
scan), then applies its residual filters and aggregates on the host, as the
reference does. ``q6_over``/``q15_over``/``q20_over`` are the same
aggregates over any mask (a brute-force scan's, for a check).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.hippo import HippoIndex
from repro_torch.core.predicate import Predicate
from repro_torch.storage.table import PagedTable

DATE_LO, DATE_HI = 0, 7 * 365          # ~1992-01-01 .. 1998-12-31 in days
PARTKEY_MAX = 200_000


@dataclass
class Lineitem:
    partkey: np.ndarray
    shipdate: np.ndarray
    discount: np.ndarray
    quantity: np.ndarray
    extendedprice: np.ndarray
    suppkey: np.ndarray

    @property
    def card(self) -> int:
        return self.partkey.shape[0]


def generate_lineitem(card: int, seed: int = 0) -> Lineitem:
    rng = np.random.default_rng(seed)
    return Lineitem(
        partkey=rng.integers(1, PARTKEY_MAX, card).astype(np.float32),
        shipdate=rng.integers(DATE_LO, DATE_HI, card).astype(np.float32),
        discount=(rng.integers(0, 11, card) / 100.0).astype(np.float32),
        quantity=rng.integers(1, 51, card).astype(np.float32),
        extendedprice=rng.uniform(900.0, 105000.0, card).astype(np.float32),
        suppkey=rng.integers(1, 10_000, card).astype(np.float32),
    )


def build_shipdate_index(li: Lineitem, page_card: int = 50,
                         resolution: int = 400, density: float = 0.2,
                         device=None) -> HippoIndex:
    """The unsharded Hippo index on ``l_shipdate`` on ``device`` (None: the
    card), over a table with the reference's 64 spare pages."""
    table = PagedTable.from_values(li.shipdate, page_card=page_card,
                                   spare_pages=64)
    return HippoIndex.create(table, resolution=resolution, density=density,
                             device=device)


def _page_select(idx: HippoIndex, lo: float, hi: float) -> np.ndarray:
    """Hippo access path: qualifying-tuple mask (flat, aligned to storage)."""
    res = idx.search(Predicate.between(lo, hi))
    return res.qualified.reshape(-1)[: idx.table.cardinality].cpu().numpy()


def q6_over(li: Lineitem, sel: np.ndarray) -> float:
    """Q6's residual filters and aggregate over a shipdate mask."""
    mask = sel & (li.discount >= 0.05) & (li.discount <= 0.07) & (li.quantity < 24)
    return float((li.extendedprice[mask] * li.discount[mask]).sum())


def q15_over(li: Lineitem, sel: np.ndarray) -> tuple[int, float]:
    """Q15's revenue view over a shipdate mask: (top suppkey, revenue)."""
    rev = np.zeros(10_000, np.float64)
    np.add.at(rev, li.suppkey[sel].astype(np.int64),
              (li.extendedprice[sel] * (1.0 - li.discount[sel])).astype(np.float64))
    return int(rev.argmax()), float(rev.max())


def q20_over(li: Lineitem, sel: np.ndarray) -> int:
    """Q20's per-(partkey, suppkey) quantity subquery over a shipdate mask."""
    key = (li.partkey[sel].astype(np.int64) * 10_000
           + li.suppkey[sel].astype(np.int64)) % (1 << 20)
    qty = np.zeros(1 << 20, np.float64)
    np.add.at(qty, key, li.quantity[sel].astype(np.float64))
    thresh = qty[key] * 0.5
    return int((li.quantity[sel] > thresh).sum())


def q6(li: Lineitem, idx: HippoIndex, date_lo: float, date_hi: float) -> float:
    """Forecasting revenue change: SUM(extendedprice * discount) over a
    shipdate range AND discount/quantity filters (plan: index scan on
    shipdate -> residual filters -> aggregate)."""
    return q6_over(li, _page_select(idx, date_lo, date_hi))


def q15(li: Lineitem, idx: HippoIndex, date_lo: float, date_hi: float):
    """Top supplier: the revenue view groups by suppkey over a shipdate
    range; the view is consumed twice (max + equality join), so the index is
    invoked twice, as in the paper's plan."""
    best = None
    for _ in range(2):
        best = q15_over(li, _page_select(idx, date_lo, date_hi))
    return best


def q20(li: Lineitem, idx: HippoIndex, date_lo: float, date_hi: float) -> int:
    """Potential part promotion (subquery form): per (partkey, suppkey) sum
    of quantity over a shipdate range; result feeds the outer join."""
    return q20_over(li, _page_select(idx, date_lo, date_hi))


def selectivity_window(sf: float) -> tuple[float, float]:
    """A shipdate window with the requested selectivity (uniform dates)."""
    width = (DATE_HI - DATE_LO) * sf
    lo = (DATE_HI - DATE_LO) / 2
    return lo, lo + width
