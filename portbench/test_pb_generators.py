"""The traffic generator and the data repeat exactly for a seed, give every
seed the same sizes and arrivals in another order, and the daily refresh
stream's (``streams/daily_retention.py``) positions and schedule agree with
its operations."""
import hashlib

import numpy as np
import pytest

import pb_data
import pb_traffic
from pb_registry import find_cell, load_stream

DBGEN = {"days": 2557, "orderdate_days": 2406, "lineitems_per_order": [1, 7],
         "ship_offset_days": [1, 121]}
MIX = {"reads": {"loop": "closed", "outstanding": 256,
                 "widths": [1, 30, 90, 365], "recent_share": 0.5,
                 "recent_days": 30, "top_k": 0}, "writes": None}


def test_queries_repeat_for_a_seed():
    a = pb_traffic.Queries(MIX, 2**31 + 17)
    b = pb_traffic.Queries(MIX, 2**31 + 17)
    c = pb_traffic.Queries(MIX, 2**31 + 18)
    got_a = [a.take(n, 2554) for n in (5, 64, 200)]
    got_b = [b.take(n, 2554) for n in (5, 64, 200)]
    for (la, ha), (lb, hb) in zip(got_a, got_b):
        assert np.array_equal(la, lb) and np.array_equal(ha, hb)
    lc, _ = c.take(269, 2554)
    assert not np.array_equal(np.concatenate([x[0] for x in got_a]), lc)


def test_every_block_holds_the_same_sizes():
    q = pb_traffic.Queries(MIX, 5)
    lo, hi = q.take(64 * 10, 2554)
    w = (hi - lo + 1).reshape(10, 64)
    for row in w:
        assert sorted(np.bincount(row, minlength=366)[[1, 30, 90, 365]]) \
            == [16, 16, 16, 16]
    recent = hi >= 2554 - 29
    assert recent.reshape(10, 64).sum(axis=1).min() >= 32
    assert lo[~recent].min() >= 0 and hi.max() <= 2554
    assert lo[~recent].min() < 100       # deleted days are asked about too


def test_arrivals_are_one_set_of_gaps_in_another_order():
    g1 = pb_traffic.poisson_gaps(2000.0, 5000, 1, pb_traffic.READ_GAPS)
    g2 = pb_traffic.poisson_gaps(2000.0, 5000, 2, pb_traffic.READ_GAPS)
    assert not np.array_equal(g1, g2)
    assert np.array_equal(np.sort(g1), np.sort(g2))
    assert g1.mean() == pytest.approx(1 / 2000.0, rel=0.01)
    d = pb_traffic.arrivals(2000.0, 2.0, 7, pb_traffic.WRITE_GAPS)
    assert np.array_equal(d, pb_traffic.arrivals(2000.0, 2.0, 7,
                                                 pb_traffic.WRITE_GAPS))
    assert d.max() < 2.0 and abs(d.size - 4000) < 300


@pytest.mark.parametrize("layout", ["dbgen", "daily"])
def test_column_repeats_for_a_seed(layout):
    cfg = dict(DBGEN, rows=50_000, layout=layout)
    a = pb_data.make_column(cfg, 2**33 + 1, "cpu").keys
    b = pb_data.make_column(cfg, 2**33 + 1, "cpu").keys
    c = pb_data.make_column(cfg, 2**33 + 2, "cpu").keys
    assert a.dtype == np.float32 and a.shape == (50_000,)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    # o_orderdate in [0, 2405] plus 1..121 days, whole days
    assert a.min() >= 1 and a.max() <= 2526 and np.all(a == np.floor(a))
    assert np.all(np.diff(a) >= 0) == (layout == "daily")


def _daily(days: int, rows_per_day: int, keys=()):
    data = pb_data.Data(keys=np.asarray(keys, np.float32),
                        order_sizes=np.zeros((0,), np.uint8))
    return load_stream({"refresh_stream": "daily_retention", "days": days,
                        "rows_per_day": rows_per_day}, 0, data)


def test_refresh_stream_positions():
    s = _daily(10, 3)
    ops = [s.op(k) for k in range(9)]
    assert ops == [("d", 0), ("w", 10), ("w", 10), ("w", 10),
                   ("d", 1), ("w", 11), ("w", 11), ("w", 11), ("d", 2)]
    assert s.newest_day(0) == 9
    for n in range(1, 9):
        written = [d for k, d in ops[:n] if k == "w"]
        assert s.newest_day(n) == (written[-1] if written else 9)
    for rows in range(0, 7):
        n = s.ops_for_rows(rows)
        assert sum(1 for k, _ in ops[:n] if k == "w") == rows
        assert n == 0 or ops[n - 1][0] == "w"


def test_refresh_stream_schedule():
    """Each row comes due at its arrival, and a day's delete with the day's
    first row; the per-day changes leave each deleted day empty."""
    s = _daily(10, 3, keys=[0, 0, 1, 2, 2, 2, 11])
    row_due = np.arange(1, 9, dtype=np.float64) * 0.5
    for first in (0, 2, 4):
        due = s.due(row_due, first)
        kinds = [s.op(k)[0] for k in range(first, first + due.size)]
        assert kinds.count("w") == row_due.size and kinds[-1] == "w"
        assert kinds.count("d") == {0: 3, 2: 2, 4: 3}[first]
        # a write at its row's arrival, a delete at the next row's
        rows_before = np.cumsum([0] + [k == "w" for k in kinds])[:-1]
        assert np.array_equal(due, row_due[rows_before])
    assert s.due(row_due[:0], 0).size == 0
    live = np.bincount(np.asarray([0, 0, 1, 2, 2, 2, 11]), minlength=22)
    for k in range(4 * 12):
        kind, day = s.op(k)
        for d, n in s.changes(k):
            live[d] += n
        if kind == "d":
            assert live[day] == 0
    # days 0-11 deleted (day 11 loaded one row and was appended three),
    # days 12-21 appended
    assert live[:12].sum() == 0 and np.all(live[12:] == 3)


@pytest.mark.parametrize("layout", ["dbgen", "daily"])
def test_order_sizes(layout):
    """They cover the rows, the keys are the parent commit's (pinned by
    digest), and on the dbgen layout an order's rows ship within 121 days
    of each other."""
    cfg = dict(DBGEN, rows=50_000, layout=layout)
    data = pb_data.make_column(cfg, 2**33 + 1, "cpu")
    sizes = data.order_sizes
    assert sizes.dtype == np.uint8 and sizes.min() >= 1 and sizes.max() <= 7
    assert int(sizes.sum()) >= 50_000
    assert hashlib.sha256(data.keys.tobytes()).hexdigest()[:16] == \
        {"dbgen": "0d552c5fb31e77db", "daily": "398192118557d768"}[layout]
    if layout == "dbgen":
        ends = np.cumsum(sizes.astype(np.int64))
        n = int(np.searchsorted(ends, 50_000)) + 1
        order = np.repeat(np.arange(n), sizes[:n])[:50_000]
        lo = np.full(n, np.inf)
        hi = np.full(n, -np.inf)
        np.minimum.at(lo, order, data.keys)
        np.maximum.at(hi, order, data.keys)
        span = hi - lo
        assert span.max() <= 120 and (span > 0).mean() > 0.5


def test_cells_use_their_mix_files(test_root):
    cell = find_cell("daily.refresh", test_root)
    assert cell.traffic["reads"]["loop"] == "open"
    assert cell.traffic["writes"]["rate_rows_per_s"] == 300
    assert find_cell("dbgen.rowids").traffic["reads"]["top_k"] == 32
    assert find_cell("dbgen.scan").traffic["reads"]["top_k"] == 0


def test_dbgen_lineitems_follow_their_order():
    """Consecutive lineitems of one order ship within 121 days of each
    other; across orders the days spread over the whole calendar."""
    cfg = dict(DBGEN, rows=7 * 28_571, layout="dbgen",
               lineitems_per_order=[7, 7])
    a = pb_data.make_column(cfg, 3, "cpu").keys.reshape(-1, 7)
    span = a.max(axis=1) - a.min(axis=1)
    assert span.max() <= 120 and np.median(span) > 60
    starts = a.min(axis=1)
    assert starts.min() <= 30 and starts.max() >= 2380
    assert np.histogram(a, bins=7, range=(1, 2527))[0].min() > 0.05 * a.size
