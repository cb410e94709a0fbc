"""TPC-H's refresh functions on the dbgen column (TPC-H v3.0.1 clause 2.5),
interleaved order by order: operation 2i is RF1's i-th new order, operation
2i + 1 is RF2's delete of the i-th loaded order.

RF1 draws its new orders from the seed as dbgen draws orders
(``pb_data.make_column``): an ``o_orderdate`` uniform over
``orderdate_days`` days and 1 to 7 lineitems, each shipping 1 to 121 days
later. Each lineitem is one ``write``, wherever its day falls on the
calendar. RF2 deletes the loaded orders in orderkey order from the first.
Loaded order i's lineitems are the rows at its load positions, found from
the cumulative sum of ``data.order_sizes``, and one ``delete_rows`` takes
them all. A row is a lineitem inserted or deleted, and an order comes due
with its first row's arrival.

The configuration states ``orders_per_refresh`` (SF x 1,500, the orders of
one refresh function) and layout ``dbgen``, on which an order's lineitems
sit together in load order.
"""
from __future__ import annotations

import numpy as np

CHUNK = 4096        # new orders drawn at a time, so the draws are the seed's
RF1_STREAM = 11     # the seed's stream for RF1 (pb_traffic's are 1 to 3)


class Stream:
    """The refresh pairs; see the module's docstring and ``pb_registry``'s
    for what each method answers."""

    def __init__(self, config: dict, seed: int, data):
        if config["layout"] != "dbgen":
            raise ValueError(f"tpch_rf deletes orders by their load "
                             f"positions, which layout {config['layout']!r} "
                             f"does not keep")
        per_refresh = 1500 * int(config["scale_factor"])
        if int(config["orders_per_refresh"]) != per_refresh:
            raise ValueError(f"orders_per_refresh "
                             f"{config['orders_per_refresh']} is not SF x "
                             f"1,500 = {per_refresh} (clause 2.5)")
        self.days = int(config["days"])
        self.orderdate_days = int(config["orderdate_days"])
        self.per_order = [int(x) for x in config["lineitems_per_order"]]
        self.offset = [int(x) for x in config["ship_offset_days"]]
        self._rng = np.random.default_rng([int(seed), RF1_STREAM])
        self._keys = np.asarray(data.keys)
        rows = self._keys.size
        sizes = np.asarray(data.order_sizes, np.int64)
        ends = np.cumsum(sizes)
        self._starts = ends - sizes
        self._ends = np.minimum(ends, rows)      # the last loaded may be cut
        self.loaded_orders = int(np.searchsorted(self._starts, rows))
        self._new_days = np.zeros((0,), np.int64)    # RF1's lineitems, flat
        self._new_ends = np.zeros((0,), np.int64)    # and each order's end

    # -- the orders ------------------------------------------------------------

    def _draw(self, orders: int) -> None:
        """Draw RF1's new orders until ``orders`` exist, a chunk at a
        time."""
        while self._new_ends.size < orders:
            n_lo, n_hi = self.per_order
            s_lo, s_hi = self.offset
            n = self._rng.integers(n_lo, n_hi + 1, CHUNK)
            od = self._rng.integers(0, self.orderdate_days, CHUNK)
            days = np.repeat(od, n) + self._rng.integers(s_lo, s_hi + 1,
                                                         int(n.sum()))
            base = self._new_days.size
            self._new_days = np.concatenate([self._new_days, days])
            self._new_ends = np.concatenate([self._new_ends,
                                             base + np.cumsum(n)])

    def new_order(self, i: int) -> np.ndarray:
        """The ship days of RF1's i-th new order's lineitems."""
        self._draw(i + 1)
        a = int(self._new_ends[i - 1]) if i else 0
        return self._new_days[a: int(self._new_ends[i])]

    def loaded_rows(self, i: int) -> tuple[int, int]:
        """[a, b): the row ids (load positions) of loaded order i."""
        if not 0 <= i < self.loaded_orders:
            raise IndexError(f"RF2 has deleted all {self.loaded_orders} "
                             f"loaded orders")
        return int(self._starts[i]), int(self._ends[i])

    # -- the stream surface ----------------------------------------------------

    def op(self, k: int) -> tuple[str, int]:
        i, j = divmod(k, 2)
        return ("w", i) if j == 0 else ("d", i)

    def issue(self, eng, k: int) -> str:
        kind, i = self.op(k)
        if kind == "w":
            for day in self.new_order(i).tolist():
                eng.write(float(day))
        else:
            a, b = self.loaded_rows(i)
            eng.delete_rows(np.arange(a, b, dtype=np.int64))
        return kind

    def changes(self, k: int) -> list[tuple[int, int]]:
        """A new order adds one row on each lineitem's day; a deleted order
        takes one from each of its loaded lineitems' days."""
        kind, i = self.op(k)
        if kind == "w":
            return [(day, 1) for day in self.new_order(i).tolist()]
        a, b = self.loaded_rows(i)
        return [(int(day), -1) for day in self._keys[a:b].tolist()]

    def rows(self, k: int) -> int:
        """The lineitems operation k inserts or deletes."""
        kind, i = self.op(k)
        if kind == "w":
            return int(self.new_order(i).size)
        a, b = self.loaded_rows(i)
        return b - a

    def newest_day(self, n_ops: int) -> int:
        """Refresh orders fall inside the loaded calendar."""
        return self.days - 1

    def ops_for_rows(self, rows: int) -> int:
        """Operations up to and including the one holding the ``rows``-th
        row."""
        k = done = 0
        while done < rows:
            done += self.rows(k)
            k += 1
        return k

    def due(self, row_due: np.ndarray, first_op: int) -> np.ndarray:
        """An order comes due with its first row."""
        out = []
        j, k = 0, first_op
        while j < len(row_due):
            out.append(row_due[j])
            j += self.rows(k)
            k += 1
        return np.asarray(out, np.float64)
