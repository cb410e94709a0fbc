#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N] [--seed S]

Run from the root of the repository on a machine with a CUDA card and
``nvcc``. It imports nothing of JAX and nothing of the JAX package. Phases,
each of which exits nonzero on failure:

1. Environment: the card's name and power limit (``nvidia-smi``), the torch
   and CUDA versions, and the ``nvcc`` build of every kernel in
   ``src/repro_torch/csrc`` (time and ``ptxas`` register counts).
2. The main path at full size, with the kernel launch counters set to 0
   just before it and read just after: TPC-H SF10 ``lineitem.l_shipdate``
   (59,986,052 rows, uniform days in [0, 2555) from ``--seed``, as the
   reference generates it) in 50-tuple pages; ``ShardedHippoIndex.create``
   with 4 shards, H=400, D=0.2 on the card; then ``QueryEngine(batch=64)``
   and ``QueryEngine(batch=64, top_k=32)`` each serve 256 seeded predicates
   (one day, 10 days, 100 days). The first batch must fall back and widen
   its slab. Every count and row-id list is checked against a brute-force
   scan on the card, and every kernel must have launched.
3. Each kernel against its plain PyTorch version on the card, exactly, at
   the main path's shapes and at ragged edges; then the kernel, the plain
   version and (where one exists) the one PyTorch call that computes the
   same function are timed with CUDA events.

The line before the last is a JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

SF10_ROWS = 59_986_052          # TPC-H SF10 lineitem cardinality
SHIPDATE_DAYS = 7 * 365          # the reference's l_shipdate domain [0, 2555)
PAGE_CARD = 50
NUM_SHARDS = 4
RESOLUTION = 400
DENSITY = 0.2
BATCH = 64
TOP_K = 32
NUM_PREDS = 256
WIDTHS = (0, 9, 99)              # one day, 10 days, 100 days (inclusive)

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM bytes/s and
# float32 operations/s outside the tensor cores, the rate these kernels'
# compares and word ops run at.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def exact(torch, name: str, got, want) -> int:
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        diff = (got.long() - want.long()).abs()
        fail(f"{name}: kernel disagrees with its plain version "
             f"(shape {tuple(got.shape)} vs {tuple(want.shape)}, "
             f"{int((diff != 0).sum()) if diff.shape == got.shape else -1} "
             f"elements differ)")
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def make_preds(Predicate, rng, n: int) -> list:
    preds = []
    for i in range(n):
        w = WIDTHS[i % len(WIDTHS)]
        lo = int(rng.integers(0, SHIPDATE_DAYS - w))
        preds.append(Predicate.between(float(lo), float(lo + w)))
    return preds


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=SF10_ROWS,
                    help="l_shipdate rows (default: TPC-H SF10)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels as K
    from repro_torch.core import index as hix
    from repro_torch.core.partition import ShardedHippoIndex
    from repro_torch.core.predicate import Predicate, intervals
    from repro_torch.kernels import _build
    from repro_torch.kernels.batch_filter import ops as bf_ops
    from repro_torch.kernels.bucketize import ops as bk_ops
    from repro_torch.kernels.compact_inspect import ops as ci_ops
    from repro_torch.runtime.engine import QueryEngine
    from repro_torch.storage.table import PagedTable

    # -- 1. environment ------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    print(f"kernels built in {time.perf_counter() - t0:.3f} s "
          f"({lib_path.relative_to(ROOT)})")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("  " + line.strip())

    # -- 2. the main path ----------------------------------------------------
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    values = rng.integers(0, SHIPDATE_DAYS, args.rows).astype(np.float32)
    table = PagedTable.from_values(values, page_card=PAGE_CARD)
    preds = make_preds(Predicate, rng, NUM_PREDS)
    print(f"data: {args.rows:,} l_shipdate rows, {table.num_pages:,} pages "
          f"({time.perf_counter() - t0:.3f} s)")

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sidx = ShardedHippoIndex.create(table, num_shards=NUM_SHARDS,
                                    resolution=RESOLUTION, density=DENSITY)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dev = sidx.device
    serve = {}
    tickets = {}
    for top_k in (0, TOP_K):
        eng = QueryEngine(sidx, batch=BATCH, top_k=top_k)
        tk = [eng.submit(p) for p in preds]
        t0 = time.perf_counter()
        eng.run_batch()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        first = (eng.stats.compact_fallbacks, eng._compact_bucket)
        eng.drain()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rest = time.perf_counter() - t1
        if first[0] == 0 or first[1] <= 64:
            fail(f"top_k={top_k}: first batch did not fall back and widen "
                 f"(fallbacks {first[0]}, bucket {first[1]})")
        st = eng.stats
        serve[top_k] = {"queries": len(preds), "seconds": dt,
                        "qps": len(preds) / dt,
                        "first_batch_s": t1 - t0,
                        "qps_after_first": (len(preds) - BATCH) / rest,
                        "first_batch_fallbacks": first[0],
                        "bucket_after_first": first[1],
                        "batches": st.batches,
                        "compact_fallbacks": st.compact_fallbacks,
                        "gather_occupancy": st.gather_occupancy,
                        "selected_page_ratio": st.selected_page_ratio}
        tickets[top_k] = tk
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print("main path: " + json.dumps({
        "rows": args.rows, "pages": table.num_pages, "shards": NUM_SHARDS,
        "pages_per_shard": sidx.spec.pages_per_shard,
        "entries": sidx.num_entries, "build_s": build_s,
        "serve": {f"top_k={k}": v for k, v in serve.items()},
        "launches": launches, "max_memory_allocated": peak}))
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")

    # brute force on the card: every count and every row-id list
    keys_all = table.device_keys(device=dev).reshape(-1)
    valid_all = table.device_valid(device=dev).reshape(-1)
    los, his = intervals(preds, dev)
    for q, p in enumerate(preds):
        hit = valid_all & (keys_all >= los[q]) & (keys_all <= his[q])
        count = int(hit.sum())
        ids = torch.nonzero(hit)[:TOP_K, 0].cpu().numpy()
        for top_k, tk in tickets.items():
            t = tk[q]
            if not t.done or t.count != count:
                fail(f"top_k={top_k} query {q} {p}: count {t.count} != "
                     f"brute force {count}")
        if not np.array_equal(tickets[TOP_K][q].row_ids, ids):
            fail(f"query {q} {p}: row ids differ from the brute-force "
                 f"first {TOP_K}")
    print(f"main path checked: {len(preds)} counts x 2 engines and "
          f"{len(preds)} row-id lists equal brute force")

    # -- 3. kernels against their plain versions, then timed -----------------
    shards = sidx.state.shards
    keys, valid = sidx._slabs()
    batch = preds[:BATCH]
    qb = sidx._query_bitmaps(batch)
    blo, bhi = intervals(batch, dev)
    live = hix._live_slots(shards)
    match = bf_ops.batch_filter_sharded(qb, shards.bitmaps, live)
    page_mask = hix._expand_page_mask(shards, match, keys.shape[1])
    sel = hix._select_union(page_mask.any(dim=1), sidx.gather_cap)
    s, q, m = keys.shape[0], len(batch), sel.shape[1]
    p = keys.shape[1]
    idx = sel.clamp(max=p - 1).long()[:, None, :].expand(s, q, m)
    sel_mask = (torch.gather(page_mask, 2, idx)
                & (sel < p)[:, None, :]).contiguous()
    n0 = min(sidx.spec.pages_per_shard, table.num_pages)
    bvals = keys[0, :n0].reshape(-1).contiguous()
    bounds = shards.bounds[0].contiguous()

    report = []

    # A: batch_filter
    err = exact(torch, "batch_filter",
                bf_ops.batch_filter_sharded(qb, shards.bitmaps, live),
                bf_ops.batch_filter_sharded_ref(qb, shards.bitmaps, live))
    e, w = shards.bitmaps.shape[1], shards.bitmaps.shape[2]
    nb, how = bound_ms(s * e * w * 4 + s * q * w * 4 + s * e + s * q * e,
                       s * q * e * w)
    report.append(("batch_filter", bf_ops.kernel, err,
                   lambda: bf_ops.batch_filter_sharded(qb, shards.bitmaps, live),
                   lambda: bf_ops.batch_filter_sharded_ref(qb, shards.bitmaps,
                                                           live),
                   None, nb, how, f"S={s} Q={q} E={e} W={w}"))
    # B: compact_inspect
    err_b = exact(torch, "compact_inspect",
                  ci_ops.compact_inspect(keys, valid, sel, sel_mask, blo, bhi),
                  ci_ops.compact_inspect_ref(keys, valid, sel, sel_mask, blo,
                                             bhi))
    c = keys.shape[2]
    pages_read = int((sel < p).sum())
    pairs = int(sel_mask.sum())
    nb, how = bound_ms(pages_read * c * 5 + s * m * 4 + s * q * m + q * 8
                       + s * q * m * 4, pairs * c * 3)
    report.append(("compact_inspect", ci_ops.kernel, err_b,
                   lambda: ci_ops.compact_inspect(keys, valid, sel, sel_mask,
                                                  blo, bhi),
                   lambda: ci_ops.compact_inspect_ref(keys, valid, sel,
                                                      sel_mask, blo, bhi),
                   None, nb, how,
                   f"S={s} Q={q} M={m} C={c} pages_read={pages_read} "
                   f"active_pairs={pairs}"))
    # C: bucketize
    err_c = exact(torch, "bucketize",
                  bk_ops.bucketize_values(bvals, bounds, RESOLUTION),
                  bk_ops.bucketize_ref(bvals, bounds, RESOLUTION))
    n = bvals.numel()
    nb, how = bound_ms(n * 8 + bounds.numel() * 4,
                       n * math.ceil(math.log2(bounds.numel() + 1)))

    def library_bucketize():
        ids = torch.searchsorted(bounds, bvals, right=True) - 1
        return ids.clamp_(0, RESOLUTION - 1)

    report.append(("bucketize", bk_ops.kernel, err_c,
                   lambda: bk_ops.bucketize_values(bvals, bounds, RESOLUTION),
                   lambda: bk_ops.bucketize_ref(bvals, bounds, RESOLUTION),
                   library_bucketize, nb, how, f"N={n} H={RESOLUTION}"))
    if not torch.equal(library_bucketize().to(torch.int32),
                       bk_ops.bucketize_values(bvals, bounds, RESOLUTION)):
        fail("bucketize disagrees with torch.searchsorted")

    ragged_edges(torch, bf_ops, ci_ops, bk_ops, dev)
    print("kernels equal their plain versions at the main path's shapes and "
          "at ragged edges")

    kernels = []
    for (name, mod, err, fk, fp, fl, nb, how, shapes) in report:
        row = {"name": name, "route": "cuda", "source": mod.SOURCE,
               "replaces": mod.REPLACES, "launches": launches[name],
               "max_abs_err": err, "ms": time_ms(torch, fk, 20),
               "plain_ms": time_ms(torch, fp, 2), "bound_ms": nb,
               "bound_by": how,
               "library_ms": time_ms(torch, fl, 20) if fl else None}
        print(f"{name}: {shapes} " + json.dumps(row))
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def ragged_edges(torch, bf_ops, ci_ops, bk_ops, dev) -> None:
    """Kernel == plain version at shapes off the kernels' tiles: Q across the
    query tile, E off the entry tile, C=50 and M=1 / M across the page tile,
    empty intervals, all-zero query rows, words with bit 31 set."""
    rng = np.random.default_rng(1)

    def words(shape, density):
        bits = rng.random((*shape, 32)) < density
        w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
        return torch.from_numpy(w.astype(np.uint32).view(np.int32)).to(dev)

    for s, q, e, w in ((3, 70, 300, 13), (1, 1, 1, 2), (2, 65, 129, 32)):
        qb = words((s, q, w), 0.02)
        qb[:, ::7] = 0                                   # all-zero queries
        qb[:, 1::5, -1] |= torch.tensor(np.uint32(1 << 31).view(np.int32),
                                        device=dev)      # bit 31 only
        ent = words((s, e, w), 0.05)
        ent[:, ::3, -1] = torch.tensor(np.uint32(1 << 31).view(np.int32),
                                       device=dev)
        live = torch.from_numpy(rng.random((s, e)) < 0.8).to(dev)
        exact(torch, f"batch_filter ragged {(s, q, e, w)}",
              bf_ops.batch_filter_sharded(qb, ent, live),
              bf_ops.batch_filter_sharded_ref(qb, ent, live))
    for s, p, c, m, q in ((2, 40, 50, 1, 5), (3, 70, 50, 33, 67),
                          (1, 5, 7, 40, 3)):
        keys = torch.from_numpy(
            rng.integers(0, 100, (s, p, c)).astype(np.float32)).to(dev)
        valid = torch.from_numpy(rng.random((s, p, c)) < 0.9).to(dev)
        sel = np.sort(rng.integers(0, p + p // 2, (s, m)), axis=1)
        sel = torch.from_numpy(np.minimum(sel, p).astype(np.int32)).to(dev)
        sel_mask = torch.from_numpy(rng.random((s, q, m)) < 0.7).to(dev)
        lo = rng.integers(0, 100, q).astype(np.float32)
        hi = lo + rng.integers(-5, 30, q).astype(np.float32)   # some empty
        los = torch.from_numpy(lo).to(dev)
        his = torch.from_numpy(hi).to(dev)
        exact(torch, f"compact_inspect ragged {(s, p, c, m, q)}",
              ci_ops.compact_inspect(keys, valid, sel, sel_mask, los, his),
              ci_ops.compact_inspect_ref(keys, valid, sel, sel_mask, los, his))
    for h in (400, 7, 1):
        b = np.cumsum(rng.random(h + 1) + 0.01).astype(np.float32)
        bounds = torch.from_numpy(b).to(dev)
        v = np.concatenate([rng.uniform(b[0] - 5, b[-1] + 5, 1000),
                            b, [3.4e38, -3.4e38]]).astype(np.float32)
        vals = torch.from_numpy(v).to(dev)
        exact(torch, f"bucketize ragged H={h}",
              bk_ops.bucketize_values(vals, bounds, h),
              bk_ops.bucketize_ref(vals, bounds, h))


if __name__ == "__main__":
    sys.exit(main())
