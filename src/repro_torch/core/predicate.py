"""Query predicates and their conversion to bucket bitmaps, §3.1 (port of
``repro.core.predicate``).

Every predicate reduces to a closed interval [lo, hi] over the attribute, so
its bucket bitmap is a contiguous run of set bits between the buckets of its
two endpoints. Endpoint bucketing goes through the bucket-probe kernel: one
launch per distinct bounds row (both endpoints of every predicate in it).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.histogram import Histogram
from repro_torch.device import resolve_device
from repro_torch.kernels.bucketize import bucketize_values

_INF = float("inf")


@dataclass(frozen=True)
class Predicate:
    """Closed-interval predicate over the indexed attribute (copied from
    ``repro.core.predicate``).

    equality(v)    -> lo = hi = v
    greater(v)     -> lo = nextafter(v), hi = +inf   (strict >)
    conjunctions   -> intersection of intervals
    """

    lo: float = -_INF
    hi: float = _INF

    @staticmethod
    def equality(v: float) -> "Predicate":
        return Predicate(lo=float(v), hi=float(v))

    @staticmethod
    def between(lo: float, hi: float) -> "Predicate":
        return Predicate(lo=float(lo), hi=float(hi))

    @staticmethod
    def greater(v: float) -> "Predicate":
        return Predicate(lo=float(np.nextafter(np.float32(v), np.float32(_INF))), hi=_INF)

    @staticmethod
    def less(v: float) -> "Predicate":
        return Predicate(lo=-_INF, hi=float(np.nextafter(np.float32(v), np.float32(-_INF))))

    def and_(self, other: "Predicate") -> "Predicate":
        return Predicate(lo=max(self.lo, other.lo), hi=min(self.hi, other.hi))

    @property
    def empty(self) -> bool:
        return self.lo > self.hi

    def selectivity_interval(self) -> tuple[float, float]:
        return (self.lo, self.hi)


_F32_MAX = 3.4e38   # finite clamp for ±inf predicate endpoints


def _finite_bounds(preds: Sequence[Predicate]) -> tuple[np.ndarray, np.ndarray]:
    """Predicate intervals as finite float32 host arrays (copied)."""
    los = np.asarray([max(p.lo, -_F32_MAX) for p in preds], np.float32)
    his = np.asarray([min(p.hi, _F32_MAX) for p in preds], np.float32)
    return los, his


def _nonempty(preds: Sequence[Predicate]) -> np.ndarray:
    return np.asarray([not p.empty for p in preds], bool)


def intervals(preds: Sequence[Predicate], device=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(los, his) float32 tensors for a batch of predicates.

    Infinities are clamped to the float32 range so the inspection compares
    stay finite; an empty predicate keeps lo > hi and matches nothing.
    """
    los, his = _finite_bounds(preds)
    dev = resolve_device(device)
    return torch.from_numpy(los).to(dev), torch.from_numpy(his).to(dev)


def interval_bitmaps(bounds: torch.Tensor, los: torch.Tensor,
                     his: torch.Tensor, nonempty: torch.Tensor
                     ) -> torch.Tensor:
    """Intervals -> (Q, W) packed query bitmaps under one bounds row.

    bounds: (H+1,) f32; los/his: (Q,) finite f32; nonempty: (Q,) bool
    (False rows produce all-zero bitmaps). Both endpoints are bucketed in
    one kernel launch; a NaN endpoint lands in bucket H-1, as the
    reference's ``searchsorted`` puts it.
    """
    h = bounds.shape[-1] - 1
    q = los.shape[0]
    ids = bucketize_values(torch.cat([los, his]).contiguous(),
                           bounds.contiguous(), h)
    words = bm.range_mask(h, ids[:q], ids[q:])
    return torch.where(nonempty[:, None], words, 0)


def interval_bitmaps_sharded(bounds: torch.Tensor, los: torch.Tensor,
                             his: torch.Tensor, nonempty: torch.Tensor
                             ) -> torch.Tensor:
    """``interval_bitmaps`` per shard: (S, H+1) stacked bounds -> (S, Q, W).

    Row s converts the batch under shard s's boundary set. Shards that share
    a bounds row (one epoch) share one conversion: one bucket-probe launch
    per distinct row.
    """
    rows, inverse = torch.unique(bounds, dim=0, return_inverse=True)
    per_row = torch.stack([interval_bitmaps(rows[r], los, his, nonempty)
                           for r in range(rows.shape[0])])
    return per_row[inverse].contiguous()


def to_bucket_bitmap(pred: Predicate, hist: Histogram) -> torch.Tensor:
    """One predicate -> its (W,) packed bitmap of hit buckets (§3.1, Fig. 2):
    ``to_bucket_bitmaps`` at Q=1, so the paths agree by construction."""
    return to_bucket_bitmaps([pred], hist)[0]


def to_bucket_bitmaps(preds: Sequence[Predicate], hist: Histogram
                      ) -> torch.Tensor:
    """Batched §3.1 conversion: Q predicates -> (Q, W) packed query bitmaps
    on the histogram's device; empty predicates give all-zero rows."""
    dev = hist.bounds.device
    if not preds:
        return bm.zeros(hist.resolution, 0, device=dev)
    los, his = intervals(preds, dev)
    nonempty = torch.from_numpy(_nonempty(preds)).to(dev)
    return interval_bitmaps(hist.bounds, los, his, nonempty)


def matches(pred: Predicate, values: torch.Tensor) -> torch.Tensor:
    """Exact tuple-level predicate evaluation (float32 compares)."""
    v = values.to(torch.float32)
    return (v >= pred.lo) & (v <= pred.hi)
