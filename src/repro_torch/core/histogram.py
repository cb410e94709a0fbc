"""Complete height-balanced (equi-depth) histogram, §4.1 (port of
``repro.core.histogram``).

Bucket convention as in the reference: ``H`` buckets with boundaries
``bounds`` of shape (H+1,); bucket ``i`` covers [bounds[i], bounds[i+1]),
the last bucket is closed on the right, and out-of-range values clamp to the
edge buckets, and a NaN value lands in bucket H-1. ``bucketize`` goes
through the bucket-probe kernel (``kernels.bucketize``) on CUDA and its
plain version on the CPU.

``build`` reproduces ``jnp.quantile`` bit for bit. ``np.quantile`` and
``torch.quantile`` do not: on a float32 sample XLA computes the linear
interpolation in float32 with the high term fused into an FMA, so about one
bound in eight differs in the last bit from a float64 interpolation. The
recipe in ``_jnp_quantile`` does the same float32 arithmetic on the host.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bucketize import bucketize_values


@dataclass(frozen=True)
class Histogram:
    """Equi-depth complete histogram: H buckets, boundaries (H+1,) float32."""

    bounds: torch.Tensor

    @property
    def resolution(self) -> int:  # H, the paper's histogram resolution
        return self.bounds.shape[0] - 1


def _jnp_quantile(sample: np.ndarray, resolution: int) -> np.ndarray:
    """``jnp.quantile(sample, jnp.linspace(0, 1, H+1))`` for a float32 sample
    without NaNs, as XLA:CPU computes it (float32 result)."""
    f32 = np.float32
    a = np.sort(np.asarray(sample, f32).ravel())
    n = a.size
    # jnp.linspace(0, 1, H+1) == iota * f32(1/H) (XLA folds the divide)
    qs = np.arange(resolution + 1, dtype=f32) * f32(1.0 / resolution)
    q = qs * f32(n - 1)
    low = np.floor(q)
    high = np.ceil(q)
    hw = (q - low).astype(f32)
    lw = (f32(1.0) - hw).astype(f32)
    lo_i = np.clip(low, 0, n - 1).astype(np.int64)
    hi_i = np.clip(high, 0, n - 1).astype(np.int64)
    lo_term = (a[lo_i] * lw).astype(f32)
    # fma(a[hi], hw, lo_term): the f32 product is exact in float64
    return (a[hi_i].astype(np.float64) * hw.astype(np.float64)
            + lo_term.astype(np.float64)).astype(f32)


def build(sample, resolution: int, device=None) -> Histogram:
    """Equi-depth histogram with ``resolution`` buckets from a sample.

    Boundaries are the (i/H)-quantiles of the sample, finalized by
    ``strict_float32_bounds`` exactly as the reference does.
    """
    if isinstance(sample, torch.Tensor):
        sample = sample.detach().cpu().numpy()
    bounds = _jnp_quantile(np.asarray(sample, np.float32), resolution)
    b32 = strict_float32_bounds(bounds.astype(np.float64))
    return Histogram(bounds=torch.from_numpy(b32).to(resolve_device(device)))


def build_uniform(lo: float, hi: float, resolution: int,
                  device=None) -> Histogram:
    """Histogram for a known-uniform attribute: ``H+1`` evenly spaced float32
    bounds from ``lo`` to exactly ``hi``.

    The steps replay what XLA:CPU makes of the reference's ``jnp.linspace``:
    with ``c1 = f32(1/H)`` and ``c2 = f32(f32(hi) * c1)`` it computes
    ``lo*(1 - i*c1) + i*c2`` (``hi*(i*c1)`` reassociated into ``i*c2``). For
    ``lo = 0``, as every caller in the repository passes it, that is
    ``f32(i*c2)`` and the bounds are bit-equal to the reference's. For
    ``lo != 0`` XLA also contracts some lanes into FMAs, depending on how it
    vectorized the loop, and a bound may differ in its last bit (ROADMAP.md,
    Faults).
    """
    f32 = np.float32
    c1 = f32(1.0 / resolution)
    c2 = f32(f32(hi) * c1)
    i = np.arange(resolution, dtype=f32)
    if lo == 0:
        body = (i * c2).astype(f32)
    else:
        body = (f32(lo) * (f32(1.0) - i * c1) + i * c2).astype(f32)
    bounds = np.concatenate([body, [f32(hi)]]).astype(f32)
    return Histogram(bounds=torch.from_numpy(bounds).to(resolve_device(device)))


def bucketize(hist: Histogram, values: torch.Tensor) -> torch.Tensor:
    """Map values to bucket ids in [0, H-1] (binary search, §4.2).

    As the reference's ``searchsorted(side="right") - 1``, clipped: a NaN
    value sorts after every bound, into bucket H-1 (the kernel's
    ``nan_last``)."""
    return bucketize_values(values.to(torch.float32).contiguous(),
                            hist.bounds, hist.resolution)


def hit_bucket_range(hist: Histogram, lo: float, hi: float
                     ) -> tuple[int, int]:
    """Bucket-id interval [b_lo, b_hi] hit by a range predicate [lo, hi].

    As in the reference: a predicate entirely outside the summary domain, or
    an empty one (lo > hi), returns the empty range (1, 0) instead of
    clamping into an edge bucket.
    """
    ends = torch.tensor([lo, hi], dtype=torch.float32,
                        device=hist.bounds.device)
    b_lo, b_hi = (int(x) for x in bucketize(hist, ends).tolist())
    lo_f, hi_f = (float(x) for x in ends.tolist())
    first, last = (float(x) for x in hist.bounds[[0, -1]].tolist())
    if hi_f < first or lo_f > last or lo_f > hi_f:
        return 1, 0
    return b_lo, b_hi


def strict_float32_bounds(bounds: np.ndarray) -> np.ndarray:
    """Finalize a nondecreasing boundary array into strictly increasing
    float32 bounds (copied from ``repro.core.histogram``).

    Cumulative-max first, then an epsilon ladder proportional to the span,
    then residual ties separated by whole float32 ulps.
    """
    b = np.maximum.accumulate(np.asarray(bounds, np.float64).ravel())
    span = max(float(b[-1] - b[0]), 1.0)
    b = b + np.arange(b.size, dtype=np.float64) * (span * 1e-6)
    b32 = b.astype(np.float32)
    for i in range(1, b32.size):
        if b32[i] <= b32[i - 1]:
            b32[i] = np.nextafter(b32[i - 1], np.float32(np.inf))
    return b32
