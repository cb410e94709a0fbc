"""The deployment's data, made from the seed: the key column and the size
of each order it was drawn from.

The column is TPC-H ``lineitem.l_shipdate`` as whole days since 1992-01-01,
drawn as dbgen draws it (TPC-H v3.0.1 clause 4.2.3), on the device in a few
calls: each order takes an ``o_orderdate`` uniform over
``[0, orderdate_days)`` and 1 to 7 lineitems, each lineitem ships 1 to 121
days after its order. Orders are drawn until the configuration's ``rows``
are reached (the last order may be cut). The days are stored as float32.
Layout ``dbgen`` keeps dbgen's load order (by orderkey: the lineitems of an
order sit together, the day is otherwise uncorrelated with the page);
layout ``daily`` sorts the column by day (a table appended day by day).

The configuration's writes are a refresh stream of its own, under
``portbench/streams/`` (``pb_registry.load_stream``), made from the
configuration, the seed and the ``Data`` below.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Data:
    """What ``make_column`` made, on the host.

    ``keys``: (rows,) float32, the key column in load order.
    ``order_sizes``: (orders,) uint8, the lineitems of every order drawn, in
    orderkey order. The first orders cover the ``rows`` keys, the last of
    them perhaps cut; more were drawn than the table holds. On layout
    ``dbgen`` order i's rows follow order i - 1's."""
    keys: np.ndarray
    order_sizes: np.ndarray


def make_column(config: dict, seed: int, device) -> Data:
    """The generated key column and its orders' sizes, each off the device
    in one copy."""
    rows = int(config["rows"])
    n_lo, n_hi = (int(x) for x in config["lineitems_per_order"])
    s_lo, s_hi = (int(x) for x in config["ship_offset_days"])
    if not 0 < n_lo <= n_hi <= 255:
        raise ValueError(f"lineitems per order {n_lo}..{n_hi} do not fit "
                         f"the order sizes' uint8")
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
    return Data(keys=days.float().cpu().numpy(),
                order_sizes=per_order.to(torch.uint8).cpu().numpy())

