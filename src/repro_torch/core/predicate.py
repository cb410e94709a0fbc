"""Query predicates and their conversion to bucket bitmaps, §3.1 (port of
``repro.core.predicate``).

Every predicate reduces to a closed interval [lo, hi] over the attribute, so
its bucket bitmap is a contiguous run of set bits between the buckets of its
two endpoints. A batch's endpoints reach the device in one copy from
page-locked memory (``upload_intervals``), and are bucketed and packed into
query bitmaps by one launch of the bucket-probe kernel's words entry under
every shard's bounds row at once: the conversion never waits on the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.histogram import Histogram
from repro_torch.device import resolve_device
from repro_torch.kernels.bucketize import bucketize_rows_words

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


def upload_intervals(preds: Sequence[Predicate], device=None
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(los, his) float32 and ``nonempty`` bool tensors for a batch of
    predicates, on ``device`` in one host-to-device copy.

    Infinities are clamped to the float32 range so the inspection compares
    stay finite; an empty predicate keeps lo > hi and matches nothing, and
    ``nonempty`` is taken from the predicates themselves (rounding to
    float32 can make an empty interval read lo == hi). The three are laid
    out on the host in one byte buffer, page-locked for a CUDA device, and
    copied with ``non_blocking=True``, so no call waits on the device; the
    caching host allocator keeps a pinned block from reuse until its copy
    has completed.
    """
    dev = resolve_device(device)
    q = len(preds)
    los, his = _finite_bounds(preds)
    host = torch.empty((9 * q,), dtype=torch.uint8,
                       pin_memory=dev.type == "cuda" and q > 0)
    buf = host.numpy()
    buf[: 4 * q] = los.view(np.uint8)
    buf[4 * q: 8 * q] = his.view(np.uint8)
    buf[8 * q:] = _nonempty(preds).view(np.uint8)
    up = host.to(dev, non_blocking=True)
    return (up[: 4 * q].view(torch.float32),
            up[4 * q: 8 * q].view(torch.float32), up[8 * q:].view(torch.bool))


def intervals(preds: Sequence[Predicate], device=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(los, his) float32 tensors for a batch of predicates
    (``upload_intervals`` without ``nonempty``)."""
    los, his, _ = upload_intervals(preds, device)
    return los, his


def interval_bitmaps(bounds: torch.Tensor, los: torch.Tensor,
                     his: torch.Tensor, nonempty: torch.Tensor
                     ) -> torch.Tensor:
    """Intervals -> (Q, W) packed query bitmaps under one bounds row.

    bounds: (H+1,) f32; los/his: (Q,) finite f32; nonempty: (Q,) bool
    (False rows produce all-zero bitmaps): ``interval_bitmaps_sharded``
    with one row.
    """
    return interval_bitmaps_sharded(bounds[None], los, his, nonempty)[0]


def interval_bitmaps_sharded(bounds: torch.Tensor, los: torch.Tensor,
                             his: torch.Tensor, nonempty: torch.Tensor
                             ) -> torch.Tensor:
    """Intervals -> (S, Q, W) packed query bitmaps, row s under shard s's
    bounds ``bounds[s]`` of the stacked (S, H+1).

    Both endpoints of every predicate are bucketed under every row, and
    the words written, in one launch of the bucket probe's words entry (on
    the CPU its plain version: the ids, a range mask, the empty predicates
    zeroed); a NaN endpoint lands in bucket H-1, as the reference's
    ``searchsorted`` puts it. Each row is converted under its own bounds, so
    shards on different bounds epochs (a drift remap partly drained) need no
    grouping, and nothing is read back.
    """
    return bucketize_rows_words(los, his, nonempty, bounds.contiguous(),
                                bounds.shape[-1] - 1)


def to_bucket_bitmap(pred: Predicate, hist: Histogram) -> torch.Tensor:
    """One predicate -> its (W,) packed bitmap of hit buckets (§3.1, Fig. 2):
    ``to_bucket_bitmaps`` at Q=1, so the paths agree by construction."""
    return to_bucket_bitmaps([pred], hist)[0]


def to_bucket_bitmaps(preds: Sequence[Predicate], hist: Histogram
                      ) -> torch.Tensor:
    """Batched §3.1 conversion: Q predicates -> (Q, W) packed query bitmaps
    on the histogram's device; empty predicates give all-zero rows."""
    return interval_bitmaps(hist.bounds,
                            *upload_intervals(preds, hist.bounds.device))


def matches(pred: Predicate, values: torch.Tensor) -> torch.Tensor:
    """Exact tuple-level predicate evaluation (float32 compares)."""
    v = values.to(torch.float32)
    return (v >= pred.lo) & (v <= pred.hi)
