"""The plain reference against the port's CPU path on a small table, with
the refresh stream's writes and deletes, and the control (the reference at
bfloat16) failing where the configuration's float32 passes."""
import numpy as np
import pytest
import torch

import pb_data
import pb_reference
from pb_registry import load_stream

CFG = {"rows": 12_000, "days": 2557, "rows_per_day": 5, "layout": "daily",
       "orderdate_days": 2406, "lineitems_per_order": [1, 7],
       "ship_offset_days": [1, 121], "refresh_stream": "daily_retention"}


def _data(cfg, seed):
    """The column and the configuration's stream, as the harness makes
    them."""
    data = pb_data.make_column(cfg, seed, "cpu")
    return data.keys, load_stream(cfg, seed, data)


def _engine(column, top_k=0):
    from repro_torch.core.partition import ShardedHippoIndex
    from repro_torch.runtime.engine import QueryEngine
    from repro_torch.storage.table import PagedTable
    table = PagedTable.from_values(column, page_card=50, spare_pages=64)
    idx = ShardedHippoIndex.create(table, num_shards=4, resolution=400,
                                   density=0.2, device="cpu")
    return QueryEngine(idx, batch=64, top_k=top_k)


def _serve(eng, lo, hi):
    from repro_torch.core.predicate import Predicate
    tickets = [eng.submit(Predicate.between(float(a), float(b)))
               for a, b in zip(lo, hi)]
    eng.drain()
    return tickets


@pytest.mark.parametrize("layout", ["daily", "dbgen"])
def test_counts_follow_writes_and_deletes(layout):
    cfg = dict(CFG, layout=layout)
    column, stream = _data(cfg, 41)
    eng = _engine(column)
    rng = np.random.default_rng(0)
    batches, n_ops = [], 0
    for step in range(6):
        lo = rng.integers(0, 2560, 64)
        hi = lo + rng.choice([0, 29, 89, 364], 64)
        tickets = _serve(eng, lo, hi)
        batches.append((n_ops, lo, hi, 0, [t.count for t in tickets],
                        [None] * 64))
        for _ in range(7 * step):          # appends and retention deletes
            stream.issue(eng, n_ops)
            n_ops += 1
    ref = pb_reference.Reference(column, stream, n_ops, "cpu")
    assert pb_reference.judge(ref, batches) == {
        "wrong_counts": 0, "wrong_row_ids": 0, "missing_answers": 0}
    # the same answers judged after the stream has been applied differ
    late = pb_reference.Reference(column, stream, n_ops, "cpu")
    late.advance(n_ops)
    assert pb_reference.judge(late, [(n_ops,) + b[1:] for b in batches]) \
        ["wrong_counts"] > 0


def test_row_ids_match_the_compact_engine():
    cfg = dict(CFG, layout="dbgen")
    column, stream = _data(cfg, 42)
    eng = _engine(column, top_k=32)
    rng = np.random.default_rng(1)
    lo = rng.integers(0, 2555 - 365, 128)
    hi = lo + rng.choice([0, 29, 89, 364], 128)
    tickets = _serve(eng, lo, hi)
    batch = (0, lo, hi, 32, [t.count for t in tickets],
             [t.row_ids for t in tickets])
    ref = pb_reference.Reference(column, stream, 0, "cpu", top_k=32)
    assert pb_reference.judge(ref, [batch]) == {
        "wrong_counts": 0, "wrong_row_ids": 0, "missing_answers": 0}
    want = np.flatnonzero((column >= lo[0]) & (column <= hi[0]))[:32]
    assert np.array_equal(tickets[0].row_ids, want)


def test_the_control_fails():
    cfg = dict(CFG, layout="dbgen")
    column, stream = _data(cfg, 43)
    rng = np.random.default_rng(2)
    lo = rng.integers(0, 2555 - 365, 256)
    hi = lo + rng.choice([0, 29, 89, 364], 256)
    exact = pb_reference.Reference(column, stream, 0, "cpu", top_k=32)
    served = [(0, lo, hi, 32, [int(c) for c in exact.counts_for(lo, hi)],
               exact.row_ids_for(lo, hi, 32))]
    assert pb_reference.judge(exact, served)["wrong_counts"] == 0
    ctl = pb_reference.Reference(column, stream, 0, "cpu",
                                 key_dtype=torch.bfloat16, top_k=32)
    got = pb_reference.judge(
        pb_reference.Reference(column, stream, 0, "cpu", top_k=32),
        pb_reference.control_answers(ctl, served))
    assert got["wrong_counts"] > 0 and got["wrong_row_ids"] > 0


@pytest.mark.parametrize("cell", ["dbgen.scan", "daily.refresh", "daily.scan",
                                  "dbgen.rowids"])
def test_every_cell_is_correct_at_a_small_size(run_tiny, cell):
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) >= {"setup_s"}
    assert list(out)[-1] == "checks"
