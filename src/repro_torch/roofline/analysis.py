"""Analytic memory/compute roofline for the five Hippo kernels (port of
``repro.roofline.analysis``).

Hippo's hot phases (bitmap_and / batch_filter / bucketize / page_inspect /
compact_inspect) are elementwise scans and reductions: arithmetic intensity
is a handful of vector ops per byte, far below any accelerator's
compute/bandwidth ridge, so every one of them is memory-bound and the honest
performance statement is *achieved bytes/s as a fraction of the memory
roofline*. This module turns a timed run into that statement:

  cost = KERNELS["bitmap_and"](e=65536, w=13)     # analytic bytes + ops
  rl   = roofline(cost, seconds, hardware("cuda_stream"))
  rl["achieved_gbps"], rl["roofline_frac"], rl["bound"]

The cost models and the roofline statement are the reference's, unchanged,
so that both packages give the same numbers for the same run. The models
count main-memory traffic on the padded dense shapes the reference's
kernels execute, with no cache modelling; ``batch_filter_cost`` and
``compact_inspect_cost`` count one re-read of the entry tile or the page
slab per query row, which the port's CUDA kernels do not pay (they read
each once). So a ``roofline_frac`` above 1.0 means the model's traffic was
beaten (by cache residency, or by a kernel that reads its operands once),
not a broken clock; such a fraction is not a bound.

The hardware table carries the H100 SXM's published peaks, a measured
device-to-device copy rate of the card in use, and a measured STREAM copy
of this host. ``hardware()`` with no argument is the card's measured row,
and raises where there is no card (the port's device rule).
"""
from __future__ import annotations

import functools
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class Hardware:
    """One row of the roofline hardware table.

    ``mem_bw`` is sustainable main-memory bandwidth in bytes/s (HBM for the
    card, measured STREAM-copy for the CPU); ``vector_ops`` is elementwise
    ops/s on the unit these kernels map to (float32 CUDA cores outside the
    tensor cores for the card, SIMD for the CPU).
    """
    name: str
    mem_bw: float
    vector_ops: float
    note: str = ""

    @property
    def ridge_ai(self) -> float:
        """Ops/byte above which a kernel stops being memory-bound."""
        return self.vector_ops / self.mem_bw


H100_SXM = Hardware("h100_sxm", mem_bw=3.35e12, vector_ops=67e12,
                    note="NVIDIA H100 SXM5 80GB HBM3 data sheet at 700 W: "
                         "HBM 3.35 TB/s, float32 67 TFLOP/s outside the "
                         "tensor cores")


@functools.lru_cache(maxsize=None)
def measure_cpu_stream(mbytes: int = 64, reps: int = 5) -> float:
    """Measured STREAM-copy bandwidth of this host in bytes/s (min-time rep).

    A 64 MiB float64 copy defeats every cache level that matters; traffic is
    2 bytes moved per byte of array (read + write). Cached per process so
    benchmark loops pay the measurement once.
    """
    n = mbytes * 2**20 // 8
    src = np.full(n, 1.0)
    dst = np.empty_like(src)
    best = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return 2 * 8 * n / best


@functools.lru_cache(maxsize=None)
def _cpu_stream_hardware() -> Hardware:
    bw = measure_cpu_stream()
    # SIMD elementwise throughput estimate: ~4 lanes x 2 ports x ~3 GHz.
    # It only decides the (never-reached) ridge.
    return Hardware("cpu_stream", mem_bw=bw, vector_ops=24e9 * 1.0,
                    note=f"measured STREAM copy {bw / 1e9:.1f} GB/s")


@functools.lru_cache(maxsize=None)
def measure_cuda_stream(mbytes: int = 1024, reps: int = 5) -> float:
    """Measured device-to-device copy bandwidth of the card in bytes/s
    (best rep, timed with CUDA events).

    A 1 GiB copy is 20x the H100's 50 MB L2, so the rate is HBM's; traffic
    is 2 bytes moved per byte of array (read + write), as for the CPU.
    Cached per process. Raises where there is no card.
    """
    dev = resolve_device(None)
    n = mbytes * 2**20
    src = torch.ones(n, dtype=torch.uint8, device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)                                   # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = math.inf
    for _ in range(reps):
        start.record()
        dst.copy_(src)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return 2 * n / best


@functools.lru_cache(maxsize=None)
def _cuda_stream_hardware() -> Hardware:
    bw = measure_cuda_stream()
    return Hardware("cuda_stream", mem_bw=bw, vector_ops=H100_SXM.vector_ops,
                    note=f"measured device copy {bw / 1e9:.1f} GB/s on "
                         f"{torch.cuda.get_device_name(resolve_device(None))}")


def hardware(name: str | None = None) -> Hardware:
    """Look up a hardware-table row; ``None`` is the card's measured row
    (``cuda_stream``), which raises where there is no card."""
    if name is None:
        resolve_device(None)
        name = "cuda_stream"
    if name == "h100_sxm":
        return H100_SXM
    if name == "cuda_stream":
        return _cuda_stream_hardware()
    if name == "cpu_stream":
        return _cpu_stream_hardware()
    raise KeyError(f"unknown hardware {name!r}; "
                   f"have: h100_sxm, cuda_stream, cpu_stream")


# ---------------------------------------------------------------------------
# per-kernel traffic/ops models (the reference's, unchanged)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelCost:
    """Mandatory main-memory bytes and elementwise vector ops for one call."""
    kernel: str
    bytes_moved: float
    ops: float

    @property
    def arithmetic_intensity(self) -> float:
        return self.ops / self.bytes_moved if self.bytes_moved else 0.0


def bitmap_and_cost(*, e: int, w: int) -> KernelCost:
    """§3.2 single-query filter: (E, W) u32 entries AND a (W,) u32 query,
    any-reduced to (E,) i32. Reads E*W words + the query, writes E flags."""
    bytes_moved = (e * w + w + e) * 4
    ops = 2.0 * e * w              # AND + nonzero/or-reduce per word
    return KernelCost("bitmap_and", bytes_moved, ops)


def batch_filter_cost(*, q: int, e: int, w: int, s: int = 1) -> KernelCost:
    """Fused batch filter: (Q, W) queries x (S, E, W) entries -> (S, Q, E)
    flags. Entries are read once per query (the reference's (Q, E) grid
    re-streams the entry tile per query row)."""
    bytes_moved = (s * q * e * w + q * w + s * q * e) * 4
    ops = 3.0 * s * q * e * w      # AND + nonzero + or-reduce
    return KernelCost("batch_filter", bytes_moved, ops)


def bucketize_cost(*, n: int, h: int) -> KernelCost:
    """§4.2 bucket probe: N f32 values binary-searched into H buckets.
    Values in, ids out; the (H+1,) bounds table is on-chip resident."""
    bytes_moved = (2 * n + (h + 1)) * 4
    ops = float(n) * math.ceil(math.log2(h + 1))
    return KernelCost("bucketize", bytes_moved, ops)


def page_inspect_cost(*, p: int, c: int) -> KernelCost:
    """§3.3 false-positive filter: (P, C) f32 keys + (P, C) bool validity
    under a (P,) page mask -> (P, C) qualifying bools + (P,) i32 counts."""
    bytes_moved = p * c * 4 + p * c + p + p * c + p * 4
    ops = 5.0 * p * c              # 2 cmps + 2 ands + count-reduce
    return KernelCost("page_inspect", bytes_moved, ops)


def compact_inspect_cost(*, q: int, m: int, c: int) -> KernelCost:
    """Gather-slab inspect: (M, C) f32 gathered keys + validity, (Q, M)
    selection mask, (Q,) bounds -> (Q, M) i32 counts. The slab is
    re-streamed per query row like batch_filter's entry tile."""
    bytes_moved = q * m * c * 4 + q * m * c + q * m + q * 8 + q * m * 4
    ops = 5.0 * q * m * c          # sel & valid & 2 cmps + count-reduce
    return KernelCost("compact_inspect", bytes_moved, ops)


KERNELS = {
    "bitmap_and": bitmap_and_cost,
    "batch_filter": batch_filter_cost,
    "bucketize": bucketize_cost,
    "page_inspect": page_inspect_cost,
    "compact_inspect": compact_inspect_cost,
}


# ---------------------------------------------------------------------------
# roofline statement
# ---------------------------------------------------------------------------

def roofline_from_traffic(bytes_moved: float, ops: float, seconds: float,
                          hw: Hardware) -> dict:
    """Roofline verdict for any (bytes, ops, time) triple on ``hw``.

    ``roofline_us`` is the analytic floor (slower of the memory and compute
    terms); ``roofline_frac`` = floor / measured — 1.0 means the run hit the
    roofline, >1.0 means the model's traffic assumption was beaten.
    """
    if seconds <= 0:
        raise ValueError(f"seconds must be positive, got {seconds}")
    t_mem = bytes_moved / hw.mem_bw
    t_ops = ops / hw.vector_ops
    t_roof = max(t_mem, t_ops)
    return {
        "hardware": hw.name,
        "bytes": float(bytes_moved),
        "ops": float(ops),
        "achieved_gbps": bytes_moved / seconds / 1e9,
        "roofline_gbps": hw.mem_bw / 1e9,
        "roofline_us": t_roof * 1e6,
        "roofline_frac": t_roof / seconds,
        "bound": "memory" if t_mem >= t_ops else "compute",
    }


def roofline(cost: KernelCost, seconds: float, hw: Hardware) -> dict:
    out = roofline_from_traffic(cost.bytes_moved, cost.ops, seconds, hw)
    out["kernel"] = cost.kernel
    return out
