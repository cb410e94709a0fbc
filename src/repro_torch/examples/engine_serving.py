"""Batched query serving: a stream of range predicates through QueryEngine
(port of ``examples/engine_serving.py``).

    PYTHONPATH=src python -m repro_torch.examples.engine_serving [--device cpu]

Simulates the multi-user serving scenario the engine exists for: a queue of
mixed-selectivity range queries is admitted into a fixed-slot batch and
executed as one batched search per batch (core.index.search_many), then the
same stream is replayed through the per-query loop to show the throughput
gap, then through a sharded index (core.partition) where the engine routes
each batch through per-shard summary bitmaps, then through the default
compact (gather) mode whose tickets also carry qualifying row ids, and
finally with writes mixed in: the async maintenance writer (runtime.writer)
stages inserts/deletes in per-shard queues and drains them between batches,
with staged rows overlaid into every count. Counts are asserted identical
between all paths.

``run`` serves any sorted column with any stream (the smoke run drives it at
TPC-H SF10) and returns what it prints; ``main`` draws the reference's data.
Runs on the card unless ``--device cpu`` is given; every clock read on the
card follows a ``torch.cuda.synchronize()``.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.hippo import HippoIndex
from repro_torch.core.partition import ShardedHippoIndex
from repro_torch.core.predicate import Predicate
from repro_torch.device import resolve_device
from repro_torch.runtime.engine import QueryEngine
from repro_torch.storage.table import PagedTable


def _clock(dev: torch.device) -> float:
    """Host seconds, once the card has finished what was queued."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def run(values: np.ndarray, preds: list, new_rows: np.ndarray,
        delete_range: tuple, *, page_card: int, device) -> dict:
    """The reference example's steps on ``values`` (a sorted column) with
    the stream ``preds``, the writes ``new_rows`` and the delete
    ``delete_range``, on ``device``. Returns the printed numbers, and each
    path's counts (``counts``, ``async_counts``, ``after_counts``)."""
    dev = resolve_device(device)
    card = len(values)
    lo_del, hi_del = delete_range
    table = PagedTable.from_values(values, page_card=page_card)
    idx = HippoIndex.create(table, resolution=400, density=0.2, device=dev)
    print(f"table: {card:,} rows / {table.num_pages} pages; "
          f"index: {idx.num_entries} entries, {idx.nbytes():,} B")
    out = {"rows": card, "pages": table.num_pages,
           "entries": idx.num_entries, "index_bytes": idx.nbytes()}

    engine = QueryEngine(idx, batch=64)
    engine.run_all(preds)   # warm the kernels + the adaptive bucket
    t0 = _clock(dev)
    counts = engine.run_all(preds)
    dt_engine = _clock(dev) - t0
    st = engine.stats
    print(f"engine:  {len(preds)} queries in {dt_engine*1e3:.1f} ms "
          f"({len(preds)/dt_engine:.0f} q/s) — {st.batches} batches, "
          f"occupancy {st.occupancy:.0%} "
          f"({st.slots_filled} real / {st.pad_slots} pad slots)")
    out["engine"] = {"ms": dt_engine * 1e3, "qps": len(preds) / dt_engine,
                     "batches": st.batches, "occupancy": st.occupancy}

    idx.search(preds[0])               # warm the single-query path
    t0 = _clock(dev)
    loop_counts = np.asarray([int(idx.search(p).count) for p in preds])
    dt_loop = _clock(dev) - t0
    print(f"loop:    {len(preds)} queries in {dt_loop*1e3:.1f} ms "
          f"({len(preds)/dt_loop:.0f} q/s)")
    out["loop"] = {"ms": dt_loop * 1e3, "qps": len(preds) / dt_loop}

    assert (counts == loop_counts).all(), "engine must be exact"
    print(f"counts identical across paths; engine speedup {dt_loop/dt_engine:.1f}x")

    # The same stream through a sharded partition layer with the routed
    # dense dispatch: the engine routes each batch through per-shard summary
    # bitmaps and reduces counts (mode="dense" + sharded=True).
    t2 = PagedTable.from_values(values, page_card=page_card)
    sidx = ShardedHippoIndex.create(t2, num_shards=4, resolution=400,
                                    density=0.2, device=dev)
    sharded = QueryEngine(sidx, batch=64, sharded=True)
    # warm every dispatch width the stream will use (steady state)
    QueryEngine(sidx, batch=64, sharded=True).run_all(preds)
    t0 = _clock(dev)
    shard_counts = sharded.run_all(preds)
    dt_shard = _clock(dev) - t0
    ss = sharded.stats
    occ = ", ".join(f"s{k}={v:.0%}" for k, v in ss.shard_occupancy().items())
    print(f"sharded: {len(preds)} queries in {dt_shard*1e3:.1f} ms "
          f"({len(preds)/dt_shard:.0f} q/s) — {ss.shard_dispatches} shard "
          f"dispatches, {ss.shards_pruned} pruned; occupancy {occ}")
    assert (shard_counts == loop_counts).all(), "sharded engine must be exact"
    out["sharded"] = {"ms": dt_shard * 1e3, "qps": len(preds) / dt_shard,
                      "shard_dispatches": ss.shard_dispatches,
                      "shards_pruned": ss.shards_pruned,
                      "shard_occupancy": ss.shard_occupancy()}

    # The default (compact) mode serves the same stream off the gathered
    # union-of-selected-pages slab — work proportional to what the batch
    # selects.
    compact = QueryEngine(sidx, batch=64)
    compact.run_all(preds)                 # warm the kernels + slab bucket
    t0 = _clock(dev)
    compact_counts = compact.run_all(preds)
    dt_compact = _clock(dev) - t0
    cs = compact.stats
    assert (compact_counts == loop_counts).all(), "compact engine must be exact"
    print(f"compact: {len(preds)} queries in {dt_compact*1e3:.1f} ms "
          f"({len(preds)/dt_compact:.0f} q/s) — selected-page ratio "
          f"{cs.selected_page_ratio:.0%}, gather occupancy "
          f"{cs.gather_occupancy:.0%}, {cs.compact_fallbacks} dense fallbacks")
    out["compact"] = {"ms": dt_compact * 1e3, "qps": len(preds) / dt_compact,
                      "selected_page_ratio": cs.selected_page_ratio,
                      "gather_occupancy": cs.gather_occupancy,
                      "compact_fallbacks": cs.compact_fallbacks}

    # With top_k set, tickets also carry qualifying global row ids.
    ids_engine = QueryEngine(sidx, batch=8, top_k=8)
    ticket = ids_engine.submit(preds[0])
    ids_engine.drain()
    vals = sidx.table.row_values(ticket.row_ids)
    lo, hi = ticket.pred.selectivity_interval()
    assert ((vals >= lo) & (vals <= hi)).all()
    print(f"compact: ticket qid={ticket.qid} carries {len(ticket.row_ids)} "
          f"row ids of its {ticket.count} matches, e.g. "
          f"{[int(i) for i in ticket.row_ids[:3]]} -> {np.round(vals[:3], 1)}")
    out["ticket"] = {"row_ids": len(ticket.row_ids), "count": ticket.count}

    # Mixed read/write serving: writes go through the engine's async
    # maintenance writer instead of running Algorithm 3 on the query path.
    # engine.write() stages the row in its shard's pending queue (a host
    # list append); the default drain policy applies one shard queue as a
    # fused batch between query batches, and explicit flush() drains the
    # rest. Staged rows are overlaid into every count, so results are exact
    # at all times — asserted against a synchronous twin below.
    t3 = PagedTable.from_values(values, page_card=page_card, spare_pages=2048)
    widx = ShardedHippoIndex.create(t3, num_shards=4, resolution=400,
                                    density=0.2, device=dev)
    wengine = QueryEngine(widx, batch=64)          # drain_policy="between_batches"
    t4 = PagedTable.from_values(values, page_card=page_card, spare_pages=2048)
    twin = ShardedHippoIndex.create(t4, num_shards=4, resolution=400,
                                    density=0.2, device=dev)

    for v in new_rows:
        wengine.write(float(v))                    # staged, off the query path
        twin.insert(float(v))                      # synchronous twin
    ws = wengine.stats
    print(f"writer:  staged {ws.queue_depth} rows across "
          f"{len(wengine.writer.pending_shards())} shard queue(s) "
          f"(peak depth {ws.peak_queue_depth})")
    out["staged"] = {"rows": ws.queue_depth,
                     "shard_queues": len(wengine.writer.pending_shards()),
                     "peak_depth": ws.peak_queue_depth}
    async_counts = wengine.run_all(preds)          # drains ride along batches
    twin_counts = np.asarray([twin.count(p) for p in preds])
    assert (async_counts == twin_counts).all(), \
        "staged counts must match the synchronous twin"
    wengine.delete(lo_del, hi_del)                 # validity mask now, vacuum queued
    t4.delete_where(lo_del, hi_del)
    twin.vacuum()
    drained = wengine.flush()                      # apply everything pending now
    ws = wengine.stats
    print(f"writer:  drained {ws.drained_rows} rows in {ws.drains} units "
          f"({ws.drain_us/1e3:.1f} ms total); flush applied {drained} rows, "
          f"queue depth {ws.queue_depth}")
    out["drain"] = {"rows": ws.drained_rows, "units": ws.drains,
                    "ms": ws.drain_us / 1e3, "flush_rows": drained,
                    "queue_depth": ws.queue_depth}
    after = wengine.run_all(preds)
    twin_after = np.asarray([twin.count(p) for p in preds])
    assert (after == twin_after).all(), "post-flush counts must match the twin"
    print("writer:  counts identical to the synchronous twin before and after "
          "the flush")
    out.update(counts=counts, async_counts=async_counts, after_counts=after)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises without a card")
    dev = resolve_device(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    card, page_card = 100_000, 50
    # Sorted keys: the time-ordered append workload (think order dates) where
    # page ranges correlate with value ranges — the case partition pruning
    # (and Hippo's page grouping itself) is built for.
    values = np.sort(rng.uniform(0, 1_000_000, card))
    # A bursty stream: 200 queries of mixed selectivity.
    preds = []
    for _ in range(200):
        lo = float(rng.uniform(0, 1e6))
        preds.append(Predicate.between(lo, lo + float(rng.choice([200.0, 1e4, 1e5]))))
    new_rows = rng.uniform(0, 1e6, 64)
    run(values, preds, new_rows, (250_000, 260_000), page_card=page_card,
        device=dev)


if __name__ == "__main__":
    main()
