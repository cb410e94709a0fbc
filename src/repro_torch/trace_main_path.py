"""Where a batch's time goes: a ``torch.profiler`` trace of the read paths
on the card.

    PYTHONPATH=src python -m repro_torch.trace_main_path [--rows N] [--seed S]

Builds the sharded index ``chip_smoke.py`` builds (TPC-H SF10
``l_shipdate`` by default, 4 shards, H=400, D=0.2) and an unsharded
``HippoIndex`` over the same column, serves one warm-up batch per dense
engine, then profiles one steady batch of 64 predicates per dense engine:
on the HippoIndex, and routed and fused on the sharded index (the compact
engine's batches are the benchmark's: ``python3 portbench/run.py
--workload dbgen.scan --seed N --seconds S --trace 1`` traces seconds of
them and puts each device-idle gap down to a stage of the read path, by
the spans of ``repro_torch.spans``); then one single-query
``HippoIndex.search`` (a 100-day predicate, after a warm-up search) and
the build of one shard (``core.index.build`` on shard 1's view: the bucket
probe, the page bits and the host grouping scan); then the
maintenance of ``chip_smoke.py``'s phase 2c on the sharded index: one eager
``insert`` (after a warm-up insert), one ``insert_batch`` of ``--rows``/1000
rows, and the ``vacuum`` after deleting one day; then the maintenance
writer of phase 2d: one staged ``write`` (after 4,096 drifting ones), the
compact batches after them with the staged rows in the overlay (with and
without a drain before them), one drain unit of each kind (a shard's
remap, the insert queue with its slab patch, a shard's vacuum after
deleting another day), and one remap of one shard
(``core.index.resummarize_shard`` alone); then durability, in a fresh
temporary directory: one full save split into its collect and its write
with the fsyncs, one delta commit of the insert queue a drain of 4,096
journaled writes changed, and one recovery of that directory (4,096 more
journaled writes staged) split into read with the CRC, decode with the
upload, and the journal replay; then model serving: ``smollm-360m`` at
its published widths in bfloat16 behind the ``BatchServer`` (batch 8,
prompts of 256 tokens), one ``admit`` (a prefill and the cache merge) and
one lock-step decode step, each after a warm-up; then training:
``smollm-360m`` in bfloat16 with float32 moments and remat on batches of 8 x
512 tokens, after two warm-up steps one whole train step, then its loss and
gradients and its AdamW update apart. Prints, per window, the wall time,
the device-busy share of that window (summed kernel time over wall time),
the device operations launched, the number of device-to-host copies (each
one a host sync) and the operators by device time.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.checkpointing import snapshot as snap
from repro_torch.checkpointing.wal import Journal
from repro_torch.core import histogram as hg
from repro_torch.core import index as hix
from repro_torch.core.hippo import HippoIndex
from repro_torch.core.histogram import Histogram
from repro_torch.core.partition import ShardedHippoIndex
from repro_torch.core.predicate import Predicate
from repro_torch.runtime.engine import QueryEngine
from repro_torch.runtime.writer import MaintenanceWriter
from repro_torch.storage.table import PagedTable

SHIPDATE_DAYS = 7 * 365
WIDTHS = (0, 9, 99)


def _preds(rng, n: int) -> list[Predicate]:
    out = []
    for i in range(n):
        w = WIDTHS[i % len(WIDTHS)]
        lo = int(rng.integers(0, SHIPDATE_DAYS - w))
        out.append(Predicate.between(float(lo), float(lo + w)))
    return out


def _kernels(prof) -> list:
    """The profile's device-side rows (kernels and copies), by time."""
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(rows, key=lambda e: e.self_device_time_total, reverse=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=59_986_052)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    table = PagedTable.from_values(
        rng.integers(0, SHIPDATE_DAYS, args.rows).astype(np.float32), 50)
    sidx = ShardedHippoIndex.create(table, num_shards=4, resolution=400,
                                    density=0.2)
    hidx = HippoIndex.create(table, resolution=400, density=0.2)
    print(f"{torch.cuda.get_device_name(0)}: {args.rows:,} rows, "
          f"{table.num_pages:,} pages")
    for name, idx, kw in (("dense HippoIndex", hidx, {"mode": "dense"}),
                          ("dense routed", sidx, {"mode": "dense"}),
                          ("dense fused", sidx, {"mode": "dense",
                                                 "sharded": False})):
        eng = QueryEngine(idx, batch=64, **kw)
        for p in _preds(rng, 64):
            eng.submit(p)
        eng.run_batch()                     # warm-up
        for p in _preds(rng, 64):
            eng.submit(p)
        torch.cuda.synchronize()
        _profiled(name, eng.run_batch)
    one = Predicate.between(1000.0, 1099.0)
    hidx.search(Predicate.between(10.0, 109.0))          # warm-up
    torch.cuda.synchronize()
    _profiled("search (one 100-day query)", lambda: hidx.search(one))
    keys, valid = sidx._slabs()
    n1 = min(sidx.spec.pages_per_shard,
             max(table.num_pages - sidx.spec.page_lo(1), 0))
    hist = Histogram(sidx.state.shards.bounds[1])
    _profiled("build of shard 1", lambda: hix.build(sidx.cfg, hist,
                                                     keys[1, :n1],
                                                     valid[1, :n1]))
    del keys, valid
    sidx.insert(5.0)                                      # warm-up
    torch.cuda.synchronize()
    _profiled("eager insert", lambda: sidx.insert(6.0))
    batch = rng.integers(0, SHIPDATE_DAYS, max(args.rows // 1000, 1))
    _profiled(f"insert_batch of {batch.size:,} rows",
              lambda: sidx.insert_batch(batch.astype(np.float32)))
    day = float(rng.integers(0, SHIPDATE_DAYS))
    table.delete_where(day, day)
    _profiled(f"vacuum after deleting day {day:g} ({table.num_dirty:,} "
              f"dirty pages)", sidx.vacuum)
    _writer_windows(rng, sidx)
    _durable_windows(rng, sidx)
    _serving_windows(args.seed)
    _training_windows(args.seed)


def _training_windows(seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.optim import adamw_init, adamw_update
    cfg = get_config("smollm-360m")
    dev = torch.device("cuda")
    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    opt = adamw_init(model)
    step = steps.make_train_step(cfg, peak_lr=1e-3, warmup=3, total=30)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (8, 513))
    batch = {"inputs": torch.from_numpy(tokens[:, :-1]).to(dev),
             "labels": torch.from_numpy(tokens[:, 1:]).to(dev),
             "positions": torch.arange(512, device=dev)[None].expand(8, 512)}
    for _ in range(2):                                    # warm-up
        model, opt, _ = step(model, opt, batch)
    torch.cuda.synchronize()
    _profiled("training: one train step (batch 8 x 512)",
              lambda: step(model, opt, batch), cpu=True)
    named = dict(model.named_parameters())
    grads = {}

    def loss_and_grads():
        loss = transformer.loss_fn(model, batch)
        grads.update(zip(named, torch.autograd.grad(loss,
                                                    list(named.values()))))

    _profiled("training: loss and gradients", loss_and_grads, cpu=True)
    _profiled("training: the AdamW update",
              lambda: adamw_update(grads, opt, model, lr=1e-4), cpu=True)


def _serving_windows(seed: int) -> None:
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import transformer
    cfg = get_config("smollm-360m")
    dev = torch.device("cuda")
    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    rng = np.random.default_rng(seed)
    server = BatchServer(model, 8, max_seq=256 + 64 + 1)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 256).astype(
        np.int32)) for i in range(8)]
    server.admit(reqs[0])                                 # warm-up
    torch.cuda.synchronize()
    _profiled("serving: admit (prefill of 256 tokens + cache merge)",
              lambda: server.admit(reqs[1]), cpu=True)
    for r in reqs[2:]:
        server.admit(r)
    server.step()                                         # warm-up
    torch.cuda.synchronize()
    _profiled("serving: one decode step at batch 8", server.step, cpu=True)


def _durable_windows(rng, sidx) -> None:
    """A full save (collect, then write + fsync), a delta commit after a
    drain of 4,096 journaled writes, and a recovery (read + CRC, decode +
    upload, replay of 4,096 journaled writes), in a temporary directory
    that is removed at the end."""
    root = Path(tempfile.mkdtemp(prefix="hippo-trace-"))
    try:
        out = {}
        _profiled("full save: collect", lambda: out.update(
            sections=snap.collect_full_sections(sidx, 0)), cpu=True)
        _profiled("full save: write + fsync", lambda: snap.write_full_snapshot(
            root, out.pop("sections")), cpu=True)
        journal = Journal(root, sidx.num_shards, sync=False)
        writer = MaintenanceWriter(sidx, journal=journal)
        for v in rng.integers(0, SHIPDATE_DAYS, 4096):
            writer.write(float(v))
        writer.drain(1)
        _profiled("delta commit (one insert-queue drain)",
                  lambda: snap.save_delta(
                      root, sidx, shards=writer.dirty_checkpoint_shards(),
                      wal_seqno=journal.last_seqno), cpu=True)
        for v in rng.integers(0, SHIPDATE_DAYS, 4096):
            writer.write(float(v))
        journal.close()
        _profiled("recover: read + CRC", lambda: out.update(
            raw=snap._load_chain(root, None)), cpu=True)
        _profiled("recover: decode + upload", lambda: out.update(
            index=snap._build_index(*out["raw"], sidx.device)), cpu=True)
        _profiled("recover: journal replay", lambda: snap._replay_journal(
            root, out["index"], *out["raw"], False)[1].close(), cpu=True)
    finally:
        shutil.rmtree(root)


def _writer_windows(rng, sidx) -> None:
    """Phase 2d's writer, in its order: a staged write (after 4,096
    drifting ones, which schedule a remap of every shard), the first batch
    after them (it drains shard 0's remap, then serves with the overlay),
    the same batch through a reader that never drains, a remap unit and
    the reader's batch after it, an insert-queue drain, a vacuum drain, and
    one remap of one shard alone."""
    eng = QueryEngine(sidx, batch=64, top_k=32)
    reader = QueryEngine(sidx, batch=64, top_k=32, drain_policy="manual",
                         writer=eng.writer)
    writer = eng.writer
    reader.run_all(_preds(rng, 64))         # warm-up, no rows staged
    new = rng.integers(SHIPDATE_DAYS, SHIPDATE_DAYS + 90, 4096)
    for v in new:
        eng.write(float(v))
    torch.cuda.synchronize()
    _profiled("staged write", lambda: eng.write(2600.0), cpu=True)
    preds = _preds(rng, 64)

    def batch(e):
        for p in preds:
            e.submit(p)
        e.run_batch()

    _profiled(f"first batch after the writes (drains a remap, then "
              f"{writer.staged_rows:,} staged rows in the overlay)",
              lambda: batch(eng), cpu=True)
    _profiled("the same batch through the reader (no drain)",
              lambda: batch(reader), cpu=True)
    _profiled("drain: remap of shard 1", lambda: writer.drain(1))
    _profiled("the reader's batch after it", lambda: batch(reader),
              cpu=True)
    writer.drain(sidx.num_shards - 2)
    reader.run_all(_preds(rng, 8))          # a fresh slab view to patch
    torch.cuda.synchronize()
    _profiled(f"drain: insert queue of {writer.queue_depth:,} rows",
              lambda: writer.drain(1), cpu=True)
    day = float(rng.integers(0, SHIPDATE_DAYS))
    eng.delete(day, day)
    _profiled(f"drain: vacuum of shard {writer.pending_vacuum_shards()[0]}",
              lambda: writer.drain(1))
    writer.flush()
    keys, valid = sidx._slabs()
    st = hix.shard_state(sidx.state.shards, 1)
    bounds = hg.rebuild(sidx.shard_histogram(1), new.astype(np.float32)
                        ).bounds
    _profiled("remap of shard 1 (resummarize_shard)",
              lambda: hix.resummarize_shard(sidx.cfg, st, keys[1], valid[1],
                                            bounds))


def _profiled(name: str, fn, cpu: bool = False) -> None:
    """Profile one call of ``fn`` (ending in a synchronize) and print its
    wall time, device-busy share and top device operators; with ``cpu``
    also the top host operators by their own host time."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = _kernels(prof)
    busy_us = sum(e.self_device_time_total for e in rows)
    d2h = sum(e.count for e in rows if "DtoH" in e.key)
    print(f"{name}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({busy_us / wall_us:.1%} of the window), "
          f"{sum(e.count for e in rows)} device operations, "
          f"{d2h} device-to-host copies")
    for e in rows[:15]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:5d} "
              f"calls  {e.key[:80]}")
    if cpu:
        host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                      reverse=True)
        for e in host[:8]:
            print(f"  host {e.self_cpu_time_total / 1e3:9.3f} ms  "
                  f"{e.count:5d} calls  {e.key[:70]}")


if __name__ == "__main__":
    main()
