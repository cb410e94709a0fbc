"""Learned summaries: error-bounded piecewise-linear CDF models that place
Hippo's bucket boundaries where the keys actually are (port of
``repro.core.learned``).

Equal-mass quantiles (``histogram.build`` / ``rebuild``) waste resolution on
duplicate-heavy keys (quantiles tie on each heavy value and are laddered
apart into stripes no tuple can land in) and, after drift, on the old
region. ``fit_cdf`` fits a monotone piecewise-linear model (FITing-Tree's
shrinking cone) to the weighted empirical CDF of a sample, with each
distinct key's mass water-filled down to at most one bucket's worth, under a
fixed segment budget; ``boundaries`` materializes it into an ordinary
``(H+1,)`` strictly increasing float32 ``Histogram``, so the bucket probe,
predicate conversion and every search path run unchanged.

Everything here is host numpy over at most a few thousand points, copied
from the reference so that both packages give the same models and the same
bounds bit for bit; the fallbacks call the port's ``histogram.build`` and
``histogram.rebuild``. A histogram is placed on an explicit device
(``boundaries``, ``build_histogram``), or on the device of the histogram it
was rebuilt from (``learned_rebuild``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import histogram as hg
from repro_torch.device import resolve_device

DEFAULT_SEGMENTS = 64    # fixed segment budget: every model has this shape
# Learned refit policy: fraction of the total mass the *old* boundary
# summary keeps. Deliberately below rebuild's equal-mass 0.5 — the reservoir
# is where the workload is writing and (under drift) querying, so it gets
# the dominant share of the boundary budget; the old region keeps enough to
# stay first-class for mixed workloads.
OLD_MASS_FRACTION = 0.25


class DegenerateSample(ValueError):
    """The sample cannot support a CDF fit (fewer than two distinct keys)."""


@dataclass(frozen=True)
class PiecewiseLinearModel:
    """A monotone piecewise-linear CDF model with a fixed segment budget.

    ``knots_x``/``knots_y`` are padded to ``segments + 1`` by repeating the
    last knot (``n_knots`` marks the filled prefix), so every model carries
    the same array shapes however many segments the fit actually needed.
    ``max_error`` is the achieved max |empirical CDF - model| over the fit
    points, in mass units (fraction of total weight).
    """
    knots_x: np.ndarray      # (segments + 1,) float64, nondecreasing
    knots_y: np.ndarray      # (segments + 1,) float64 CDF values in [0, 1]
    n_knots: int             # filled prefix length (>= 2)
    segments: int            # the fixed budget the fit was run under
    max_error: float         # achieved sup-norm error, mass units

    @property
    def used_segments(self) -> int:
        return self.n_knots - 1

    def cdf(self, xs) -> np.ndarray:
        """Model CDF at ``xs`` (clamped to [0, 1] outside the knot span)."""
        return np.interp(np.asarray(xs, np.float64),
                         self.knots_x[: self.n_knots],
                         self.knots_y[: self.n_knots])


def _weighted_cdf_points(sample, weights, mass_clamp: float | None = None
                         ) -> tuple[np.ndarray, np.ndarray]:
    """(x, y): distinct sorted keys and the empirical CDF *at* each key
    (inclusive), weights normalized to total mass 1. Ties collapse into one
    point carrying their summed mass.

    ``mass_clamp`` (typically ``1/H``) caps any single distinct key's mass
    at one bucket's worth — the boundary-allocation correction for
    duplicate-heavy keys. ``bucketize`` is a point lookup, so every
    duplicate of one key lands in one bucket no matter how many boundaries
    equal-mass quantiles tie onto it; mass beyond one bucket's worth is
    dead weight for summary placement, and the clamp water-fills it back
    into the keys that can still absorb boundaries, so the materialized
    grid spends the freed budget where it can actually prune."""
    x = np.asarray(sample, np.float64).ravel()
    if weights is None:
        w = np.full(x.size, 1.0 / max(x.size, 1))
    else:
        w = np.asarray(weights, np.float64).ravel()
        if w.shape != x.shape:
            raise ValueError(f"weights shape {w.shape} != sample {x.shape}")
        total = w.sum()
        if not np.isfinite(total) or total <= 0:
            raise ValueError("weights must be finite with positive total")
        w = w / total
    order = np.argsort(x, kind="stable")
    x, w = x[order], w[order]
    cum = np.cumsum(w)
    # inclusive CDF at each *distinct* x: keep the last position of each run
    last = np.ones(x.size, bool)
    last[:-1] = x[1:] != x[:-1]
    xd, cumd = x[last], cum[last]
    if mass_clamp is not None and xd.size > 1:
        mass = np.diff(cumd, prepend=0.0)
        mass = _clamp_masses(mass, float(mass_clamp))
        cumd = np.cumsum(mass)
        cumd /= cumd[-1]
    return xd, cumd


def _clamp_masses(mass: np.ndarray, clamp: float) -> np.ndarray:
    """Water-fill per-key masses so none exceeds ``clamp`` and the total
    stays 1: scale the unsaturated keys up uniformly, saturating keys at
    the cap as the scale pushes them over, until the scaled remainder fits.
    Exact fixed point (each round saturates at least one key, and at most
    ``1/clamp`` keys can ever saturate, so the loop is short); when every
    key caps out — fewer distinct keys than buckets — mass goes uniform,
    which is the best a point-lookup summary can do."""
    if not 0.0 < clamp < 1.0 or mass.max() <= clamp:
        return mass
    sat = np.zeros(mass.size, bool)
    for _ in range(mass.size):
        free = 1.0 - clamp * sat.sum()
        unsat_mass = mass[~sat].sum()
        if free <= 0.0 or unsat_mass <= 0.0:
            break
        scale = free / unsat_mass
        newly = ~sat & (mass * scale > clamp)
        if not newly.any():
            out = np.where(sat, clamp, mass * scale)
            return out / out.sum()
        sat |= newly
    return np.full(mass.size, 1.0 / mass.size)


def _greedy_knots(x: np.ndarray, y: np.ndarray, eps: float) -> list[int]:
    """FITing-Tree's shrinking cone: indices of a maximal greedy knot set
    such that some line from each knot stays within ``eps`` of every point
    up to the next knot. O(n) — each point narrows one cone once."""
    n = x.size
    knots = [0]
    s = 0
    while s < n - 1:
        lo, hi = -np.inf, np.inf
        j = s + 1
        while j < n:
            dx = x[j] - x[s]
            lo = max(lo, (y[j] - eps - y[s]) / dx)
            hi = min(hi, (y[j] + eps - y[s]) / dx)
            if lo > hi:        # cone emptied: previous point ends the segment
                break
            j += 1
        end = j - 1 if j < n else n - 1
        knots.append(end)
        s = end
    return knots


def fit_cdf(sample, weights=None, *, segments: int = DEFAULT_SEGMENTS,
            mass_clamp: float | None = None) -> PiecewiseLinearModel:
    """Fit a monotone piecewise-linear CDF with at most ``segments``
    segments, minimizing the error bound by binary search.

    The greedy cone pass is monotone in eps (larger eps => fewer segments),
    so ~40 bisection steps over [0, 1] find the smallest error bound whose
    greedy cover fits the budget; the knots are the empirical CDF points at
    the final cover's cut positions (monotone by construction, so the
    inverse CDF in ``boundaries`` is well defined).

    With ``mass_clamp`` the fit target is the *boundary-allocation* CDF —
    per-key mass capped at one bucket's worth (see ``_weighted_cdf_points``)
    — rather than the raw data CDF; ``max_error`` is measured against that
    target. Raises ``DegenerateSample`` when the sample has fewer than two
    distinct keys — there is no CDF to fit; callers fall back to the
    equal-mass path.
    """
    if segments < 1:
        raise ValueError(f"segments must be >= 1, got {segments}")
    x, y = _weighted_cdf_points(sample, weights, mass_clamp)
    if x.size < 2:
        raise DegenerateSample(
            f"need >= 2 distinct keys to fit a CDF, got {x.size}")
    lo, hi = 0.0, 1.0
    knots = None
    if len(_greedy_knots(x, y, 0.0)) - 1 <= segments:
        knots, hi = _greedy_knots(x, y, 0.0), 0.0       # exactly representable
    else:
        for _ in range(40):
            mid = 0.5 * (lo + hi)
            k = _greedy_knots(x, y, mid)
            if len(k) - 1 <= segments:
                hi, knots = mid, k
            else:
                lo = mid
    idx = np.asarray(knots, np.int64)
    kx = np.full(segments + 1, x[idx[-1]], np.float64)
    ky = np.full(segments + 1, y[idx[-1]], np.float64)
    kx[: idx.size] = x[idx]
    ky[: idx.size] = y[idx]
    achieved = float(np.abs(
        np.interp(x, kx[: idx.size], ky[: idx.size]) - y).max())
    return PiecewiseLinearModel(knots_x=kx, knots_y=ky, n_knots=int(idx.size),
                                segments=segments, max_error=achieved)


def boundaries(model: PiecewiseLinearModel, resolution: int,
               device=None) -> hg.Histogram:
    """Materialize H adaptive bucket boundaries from the model: inverse CDF
    at the equi-mass grid, finalized to strictly increasing float32 (the
    invariant ``writer._drain_resummarize`` validates). The result is an
    ordinary ``Histogram`` on ``device`` (None: the card)."""
    kx = model.knots_x[: model.n_knots]
    ky = model.knots_y[: model.n_knots]
    qs = np.linspace(0.0, 1.0, resolution + 1)
    b = np.interp(qs, ky, kx)
    b[0], b[-1] = kx[0], kx[-1]          # edges cover the modeled span
    return hg.Histogram(bounds=torch.from_numpy(
        hg.strict_float32_bounds(b)).to(resolve_device(device)))


def build_histogram(sample, resolution: int,
                    *, segments: int = DEFAULT_SEGMENTS, device=None
                    ) -> tuple[hg.Histogram, PiecewiseLinearModel | None]:
    """CREATE INDEX path: fit the build sample and materialize bounds on
    ``device`` (None: the card).

    Returns ``(hist, model)``; on a degenerate sample the equal-mass
    builder is the fallback/oracle and ``model`` is None.
    """
    sample = np.asarray(sample, np.float32).ravel()
    try:
        model = fit_cdf(sample, segments=segments,
                        mass_clamp=1.0 / resolution)
    except DegenerateSample:
        return hg.build(sample, resolution, device=device), None
    return boundaries(model, resolution, device), model


def learned_rebuild(hist: hg.Histogram, sample: np.ndarray,
                    resolution: int | None = None,
                    *, segments: int = DEFAULT_SEGMENTS,
                    old_mass: float = OLD_MASS_FRACTION
                    ) -> tuple[hg.Histogram, PiecewiseLinearModel | None]:
    """Drift-refit path: fit {old boundary summary, reservoir sample} with
    the reservoir carrying ``1 - old_mass`` of the total mass.

    The learned twin of ``histogram.rebuild`` (same inputs, same no-table-
    re-read contract): the old bounds' H+1 points summarize the pre-drift
    distribution and keep ``old_mass`` of the boundary budget; the reservoir
    — where the workload is writing, and under drift querying — gets the
    rest, plus the PLR smoothing that stops duplicate-heavy reservoirs from
    collapsing quantiles into epsilon ladders. Returns ``(hist, model)``;
    degenerate inputs fall back to equal-mass ``rebuild`` with model None.
    The histogram is on ``hist``'s device.
    """
    sample = np.asarray(sample, np.float32).ravel()
    if sample.size == 0:
        raise ValueError("learned_rebuild needs a non-empty sample of "
                         "recent inserts")
    if not 0.0 <= old_mass < 1.0:
        raise ValueError(f"old_mass must be in [0, 1), got {old_mass}")
    if resolution is None:
        resolution = hist.resolution
    old_pts = hg.host_bounds(hist).astype(np.float64)
    pts = np.concatenate([old_pts, sample.astype(np.float64)])
    wts = np.concatenate([
        np.full(old_pts.size, old_mass / old_pts.size),
        np.full(sample.size, (1.0 - old_mass) / sample.size)])
    try:
        model = fit_cdf(pts, wts, segments=segments,
                        mass_clamp=1.0 / resolution)
    except DegenerateSample:
        return hg.rebuild(hist, sample, resolution), None
    return boundaries(model, resolution, hist.bounds.device), model
