"""TPC-H's refresh pairs as ``tpch_rf`` draws and interleaves them, each
order committed as one transaction: RF1's i-th new order is one
``write_many`` of its lineitems' ship days, so a durable engine journals
it as one record with one fsync, as a loader committing an order at a
time does (TPC-H v3.0.1 clause 2.5 lets a refresh function commit any
number of times, an order with its lineitems in one transaction). RF2's
deletes stay one ``delete_rows`` an order.

Everything else is ``tpch_rf``'s stream, made by ``pb_registry.load_stream``
for the same configuration, seed and data and asked in turn: the draws,
``op``, ``changes``, ``rows``, ``due`` and ``ops_for_rows``, so the
reference sees exactly ``dbgen.refresh``'s changes.
"""
from __future__ import annotations

import numpy as np

import pb_registry


class Stream:
    """``tpch_rf``'s refresh pairs, an RF1 order in one call."""

    def __init__(self, config: dict, seed: int, data):
        self._rf = pb_registry.load_stream(
            dict(config, refresh_stream="tpch_rf"), seed, data)

    def __getattr__(self, name):
        return getattr(self._rf, name)

    def issue(self, eng, k: int) -> str:
        kind, i = self._rf.op(k)
        if kind == "w":
            eng.write_many(self._rf.new_order(i).astype(np.float64))
        else:
            a, b = self._rf.loaded_rows(i)
            eng.delete_rows(np.arange(a, b, dtype=np.int64))
        return kind
