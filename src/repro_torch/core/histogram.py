"""Complete height-balanced (equi-depth) histogram, §4.1 (port of
``repro.core.histogram``).

Bucket convention as in the reference: ``H`` buckets with boundaries
``bounds`` of shape (H+1,); bucket ``i`` covers [bounds[i], bounds[i+1]),
the last bucket is closed on the right, and out-of-range values clamp to the
edge buckets, and a NaN value lands in bucket H-1. ``bucketize`` goes
through the bucket-probe kernel (``kernels.bucketize``) on CUDA and its
plain version on the CPU.

Drift telemetry and the boundary rebuild (``DriftTracker``, ``rebuild``,
``host_bounds``) are host numpy, copied from the reference; a histogram they
return lives on the device of the histogram it came from.

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


def _quantile_weights(n: int, resolution: int) -> tuple:
    """The gather indices and float32 weights of ``jnp.quantile`` at
    ``jnp.linspace(0, 1, H+1)`` over ``n`` sorted values, as XLA:CPU
    computes them: (lo_i, hi_i int64, lw, hw float32), each (H+1,)."""
    f32 = np.float32
    # jnp.linspace(0, 1, H+1) == iota * f32(1/H) (XLA folds the divide)
    qs = np.arange(resolution + 1, dtype=f32) * f32(1.0 / resolution)
    q = qs * f32(n - 1)
    low = np.floor(q)
    high = np.ceil(q)
    hw = (q - low).astype(f32)
    lw = (f32(1.0) - hw).astype(f32)
    return (np.clip(low, 0, n - 1).astype(np.int64),
            np.clip(high, 0, n - 1).astype(np.int64), lw, hw)


def _jnp_quantile(sample: np.ndarray, resolution: int) -> np.ndarray:
    """``jnp.quantile(sample, jnp.linspace(0, 1, H+1))`` for a float32 sample
    without NaNs, as XLA:CPU computes it (float32 result)."""
    f32 = np.float32
    a = np.sort(np.asarray(sample, f32).ravel())
    lo_i, hi_i, lw, hw = _quantile_weights(a.size, resolution)
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


def host_bounds(hist: Histogram) -> np.ndarray:
    """The bounds as a host float32 array (a copy: it never aliases the
    state's tensor)."""
    return hist.bounds.cpu().numpy().copy()


# ---------------------------------------------------------------------------
# Drift telemetry + incremental boundary rebuild (copied from the reference)
# ---------------------------------------------------------------------------

class DriftTracker:
    """Insert-stream drift telemetry against a fixed boundary set.

    Host-side and O(log H) per observed value: each insert is bucketized
    against the armed bounds (per-bucket hit counters, ``np.searchsorted``,
    so a NaN value lands in bucket H-1 as in the reference), counted as
    out-of-range if it falls outside [bounds[0], bounds[-1]), and offered to
    a fixed-size reservoir (algorithm R, the reference's seeded generator)
    so ``rebuild`` later sees an unbiased sample of the whole stream since
    the last ``rearm``.

    ``edge_overflow_ratio`` is the drift signal: the fraction of observed
    inserts that clamped into the two edge buckets.
    """

    def __init__(self, hist: Histogram, reservoir_size: int = 4096,
                 seed: int = 0):
        self._reservoir_size = reservoir_size
        self._seed = seed
        self.rearm(hist)

    def rearm(self, hist: Histogram) -> None:
        """Reset every counter and the reservoir against new bounds."""
        self._device = hist.bounds.device
        self._bounds = host_bounds(hist)
        self.resolution = self._bounds.shape[0] - 1
        self.hits = np.zeros((self.resolution,), np.int64)
        self.observed = 0
        self.out_of_range = 0
        self.reservoir = np.empty((self._reservoir_size,), np.float32)
        self._res_fill = 0
        self._rng = np.random.default_rng(self._seed)

    def observe(self, values) -> None:
        """Fold a batch (or scalar) of inserted values into the telemetry:
        one ``searchsorted`` for the counters and one batched algorithm-R
        admission for the reservoir, equal to the per-value loop."""
        vals = np.asarray(values, np.float32).ravel()
        if vals.size == 0:
            return
        ids = np.clip(np.searchsorted(self._bounds, vals, side="right") - 1,
                      0, self.resolution - 1)
        np.add.at(self.hits, ids, 1)
        self.out_of_range += int(((vals < self._bounds[0])
                                  | (vals >= self._bounds[-1])).sum())
        start = self.observed
        self.observed += vals.size
        # fill the reservoir's empty prefix directly ...
        take = min(self.reservoir.size - self._res_fill, vals.size)
        if take > 0:
            self.reservoir[self._res_fill: self._res_fill + take] = vals[:take]
            self._res_fill += take
        rest = vals[take:]
        if rest.size == 0:
            return
        # ... then admit the overflow: value k (1-based running count c_k)
        # replaces a uniform slot j ~ [0, c_k) when j lands in the reservoir
        counts = start + take + 1 + np.arange(rest.size, dtype=np.int64)
        j = self._rng.integers(0, counts)
        admit = j < self.reservoir.size
        self.reservoir[j[admit]] = rest[admit]

    @property
    def armed_histogram(self) -> Histogram:
        """The boundary set drift is currently measured against, on the
        device of the histogram it was armed with."""
        return Histogram(torch.from_numpy(self._bounds.copy()).to(
            self._device))

    @property
    def edge_overflow_ratio(self) -> float:
        """Fraction of observed inserts that landed in an edge bucket; 0.0
        before anything is observed."""
        if not self.observed:
            return 0.0
        return float(self.hits[0] + self.hits[-1]) / self.observed

    def sample(self) -> np.ndarray:
        """Copy of the reservoir's filled prefix (<= reservoir_size values)."""
        return self.reservoir[: self._res_fill].copy()


def rebuild(hist: Histogram, sample: np.ndarray, resolution: int | None = None,
            *, old_count: int | None = None, new_count: int | None = None
            ) -> Histogram:
    """New equi-depth boundary set after drift, without re-reading the table:
    a weighted quantile over {old boundary points, reservoir sample points}
    (``old_count``/``new_count`` weight the two sets; default equal mass),
    finalized by ``strict_float32_bounds``. The result is on ``hist``'s
    device."""
    sample = np.sort(np.asarray(sample, np.float32).ravel())
    if sample.size == 0:
        raise ValueError("rebuild needs a non-empty sample of recent inserts")
    if resolution is None:
        resolution = hist.resolution
    old_pts = host_bounds(hist).astype(np.float64)
    old_count = sample.size if old_count is None else max(int(old_count), 0)
    new_count = sample.size if new_count is None else max(int(new_count), 0)
    if old_count + new_count == 0:
        old_count = new_count = 1
    pts = np.concatenate([old_pts, sample.astype(np.float64)])
    wts = np.concatenate([
        np.full(old_pts.size, old_count / old_pts.size),
        np.full(sample.size, new_count / sample.size)])
    order = np.argsort(pts, kind="stable")
    pts, wts = pts[order], wts[order]
    cum = np.cumsum(wts)
    cum /= cum[-1]
    qs = np.linspace(0.0, 1.0, resolution + 1)
    bounds = np.interp(qs, cum, pts)
    bounds[0] = pts[0]          # edges cover the full blended range
    bounds[-1] = pts[-1]
    return Histogram(bounds=torch.from_numpy(strict_float32_bounds(bounds)).to(
        hist.bounds.device))
