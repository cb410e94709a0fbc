"""Hippo cost estimation models (§6) (a copy of ``repro.core.cost``).

Host math only, kept as the reference's own lines so that every function
returns the same float, bit for bit; the port imports nothing of ``repro``,
so it keeps this copy. The formulas price what the comparison phases of
``chip_smoke.py`` measure: inspected tuples per query, entries and bytes,
and the I/Os of an insert beside a B+-tree's.

Notation (Table 2): H resolution, D density threshold, P pages/entry,
T tuples/entry, Card cardinality, pageCard tuples/page, SF selectivity factor.
"""
from __future__ import annotations

import math


def prob_inspect(sf: float, resolution: int, density: float) -> float:
    """Probability a partial histogram has joint buckets with the predicate.

    Formula 1 piecewise: Prob = (SF*H)*D clipped to 1, with SF*H >= 1 because a
    non-empty predicate hits at least one bucket (§6.1).
    """
    hit_buckets = max(1.0, math.ceil(sf * resolution))
    return min(1.0, hit_buckets * density)


def query_time_tuples(sf: float, resolution: int, density: float, card: int) -> float:
    """Formula 2: expected inspected tuples (the disk-I/O proxy)."""
    return prob_inspect(sf, resolution, density) * card


def tuples_per_entry(resolution: int, density: float) -> float:
    """Formula 3: coupon-collector expectation T(H, D).

    T = H * (1/H + 1/(H-1) + ... + 1/(H - D*H + 1)) — tuples drawn until D*H
    distinct buckets are collected.
    """
    h = resolution
    k = max(1, int(round(density * h)))
    return h * sum(1.0 / (h - j) for j in range(k))


def pages_per_entry(resolution: int, density: float, page_card: int) -> float:
    """Formula 4: P = T / pageCard (valid when D*H >= pageCard)."""
    return tuples_per_entry(resolution, density) / page_card


def num_entries(card: int, resolution: int, density: float) -> float:
    """Formula 5/6: expected index entry count Card / T."""
    return card / tuples_per_entry(resolution, density)


def entry_nbytes(resolution: int) -> int:
    """Bytes per entry: packed bitmap words + 2 page ids + sorted-list ptr."""
    words = (resolution + 31) // 32
    return words * 4 + 8 + 4


def index_nbytes(card: int, resolution: int, density: float) -> float:
    """Index size estimate = entries * entry size (§6.2)."""
    return num_entries(card, resolution, density) * entry_nbytes(resolution)


def init_time_ios(card: int, resolution: int, density: float) -> float:
    """Formula 7: Card tuple reads + one write per entry."""
    return card + num_entries(card, resolution, density)


def insert_time_ios(card: int, resolution: int, density: float) -> float:
    """Formula 8: log(entries) sorted-list binary search + 4 constant I/Os."""
    e = max(2.0, num_entries(card, resolution, density))
    return math.log2(e) + 4.0


def btree_insert_time_ios(card: int) -> float:
    """B+-Tree comparison point used in §7.3.2: ~log(Card) per insert."""
    return math.log2(max(2, card))
