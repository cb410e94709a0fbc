"""Min-max sparse index baseline (BRIN / Zone Map, §8 "Sparse Index
Structures") (port of ``repro.core.baselines.minmax``).

Stores per page range only the (min, max) of the key. On unordered attributes
the ranges cover nearly the whole domain, so most predicates overlap most
ranges: the failure mode Hippo's histogram summaries fix (§1, §8). Plain
torch on the table's device views.

As in the reference, a NaN key makes its range's min and max NaN, so the
range is never inspected and its rows are lost to every predicate (a fault
of the reference, reproduced for parity; ROADMAP.md queue 3).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.baselines.fullscan import bound32


@dataclass(frozen=True)
class MinMaxIndex:
    pages_per_range: int
    mins: torch.Tensor  # (R,) f32
    maxs: torch.Tensor  # (R,) f32

    @staticmethod
    def build(keys: torch.Tensor, valid: torch.Tensor,
              pages_per_range: int = 1) -> "MinMaxIndex":
        """keys (P, C) f32 and valid (P, C) bool, on their device. The last
        range is padded with zero keys that are not valid; a range with no
        valid tuple gets +inf as its min and -inf as its max."""
        num_pages, c = keys.shape
        r = (num_pages + pages_per_range - 1) // pages_per_range
        pad = r * pages_per_range - num_pages
        k = torch.nn.functional.pad(keys.to(torch.float32), (0, 0, 0, pad))
        v = torch.nn.functional.pad(valid, (0, 0, 0, pad))
        k = k.reshape(r, pages_per_range * c)
        v = v.reshape(r, pages_per_range * c)
        inf = torch.tensor(float("inf"), device=keys.device)
        mins = torch.where(v, k, inf).amin(dim=1)
        maxs = torch.where(v, k, -inf).amax(dim=1)
        return MinMaxIndex(pages_per_range=pages_per_range, mins=mins,
                           maxs=maxs)

    def search(self, keys: torch.Tensor, valid: torch.Tensor, lo, hi
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(count, pages inspected) as int32 tensors for predicate [lo, hi]."""
        lo, hi = bound32(lo), bound32(hi)
        num_pages = keys.shape[0]
        overlap = (self.mins <= hi) & (self.maxs >= lo)           # (R,)
        page_mask = overlap.repeat_interleave(self.pages_per_range)[:num_pages]
        v = keys.to(torch.float32)
        qual = page_mask[:, None] & valid & (v >= lo) & (v <= hi)
        return qual.sum(dtype=torch.int32), page_mask.sum(dtype=torch.int32)

    def nbytes(self) -> int:
        return int(self.mins.shape[0]) * 8  # two float32 per range
