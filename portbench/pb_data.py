"""The deployment's data, made from the seed: the key column and the
refresh stream.

The column is TPC-H ``lineitem.l_shipdate`` as whole days since 1992-01-01,
drawn as dbgen draws it (TPC-H v3.0.1 clause 4.2.3), on the device in a few
calls: each order takes an ``o_orderdate`` uniform over
``[0, orderdate_days)`` and 1 to 7 lineitems, each lineitem ships 1 to 121
days after its order. Orders are drawn until the configuration's ``rows``
are reached (the last order may be cut). The days are stored as float32.
Layout ``dbgen`` keeps dbgen's load order (by orderkey: the lineitems of an
order sit together, the day is otherwise uncorrelated with the page);
layout ``daily`` sorts the column by day (a table appended day by day).

The refresh stream is one fixed sequence of operations. Row r of the appends
carries day ``days + r // rows_per_day``; before every row with
``r % rows_per_day == 0`` the oldest whole day is deleted, so the table holds
a rolling window of ``days`` days. ``RefreshStream.op(k)`` is the k-th
operation.
"""
from __future__ import annotations

import numpy as np
import torch


def make_column(config: dict, seed: int, device) -> np.ndarray:
    """(rows,) float32 host copy of the generated key column."""
    rows = int(config["rows"])
    n_lo, n_hi = (int(x) for x in config["lineitems_per_order"])
    s_lo, s_hi = (int(x) for x in config["ship_offset_days"])
    # enough orders that their lineitems pass ``rows`` by many deviations
    orders = int(rows / ((n_lo + n_hi) / 2) * 1.05) + 64
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    per_order = torch.randint(n_lo, n_hi + 1, (orders,), generator=g,
                              device=device, dtype=torch.int64)
    orderdate = torch.randint(0, int(config["orderdate_days"]), (orders,),
                              generator=g, device=device, dtype=torch.int32)
    order_of_row = torch.repeat_interleave(
        torch.arange(orders, device=device), per_order)
    if order_of_row.numel() < rows:
        raise ValueError(f"{orders} orders gave {order_of_row.numel()} "
                         f"lineitems, fewer than {rows}")
    days = orderdate[order_of_row[:rows]] + torch.randint(
        s_lo, s_hi + 1, (rows,), generator=g, device=device,
        dtype=torch.int32)
    del order_of_row
    if config["layout"] == "daily":
        days = torch.sort(days).values
    elif config["layout"] != "dbgen":
        raise ValueError(f"unknown layout {config['layout']!r}")
    return days.float().cpu().numpy()


class RefreshStream:
    """The configuration's appends and retention deletes, in order.

    Operation k is ``("d", day)`` or ``("w", day)``; a delete precedes the
    first row of every day (``delete(day, day)`` of the oldest day).
    """

    def __init__(self, config: dict):
        self.days = int(config["days"])
        # only a configuration with a refresh stream states it
        self.rows_per_day = int(config.get("rows_per_day", 0))

    def op(self, k: int) -> tuple[str, int]:
        per = self.rows_per_day + 1          # one delete, then a day of rows
        day, j = divmod(k, per)
        if j == 0:
            return ("d", day)
        return ("w", self.days + day)

    def ops_for_rows(self, rows: int) -> int:
        """Operations up to and including the ``rows``-th append."""
        if rows <= 0:
            return 0
        day, j = divmod(rows - 1, self.rows_per_day)
        return day * (self.rows_per_day + 1) + j + 2

    def newest_day(self, n_ops: int) -> int:
        """The newest day in the table after the first ``n_ops``
        operations."""
        rows = n_ops - ((n_ops - 1) // (self.rows_per_day + 1) + 1) \
            if n_ops > 0 else 0
        return self.days + (rows - 1) // self.rows_per_day if rows else \
            self.days - 1
