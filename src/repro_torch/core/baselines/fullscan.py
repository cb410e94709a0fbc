"""Sequential scan baseline: zero index storage, Card inspection cost (port
of ``repro.core.baselines.fullscan``).

The bounds compare in float32, as the reference's ``jnp`` compare takes a
Python scalar as a weak type and rounds it to float32 (``bound32``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def bound32(x):
    """A predicate bound as the reference's float32 compare sees it: a
    Python or numpy number rounded to float32 (kept as a Python float, which
    float32 holds exactly), a tensor cast to float32."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return float(np.float32(x))


@dataclass(frozen=True)
class FullScan:
    @staticmethod
    def search(keys: torch.Tensor, valid: torch.Tensor, lo, hi
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """(count, pages inspected) as int32 tensors on the keys' device."""
        v = keys.to(torch.float32)
        qual = valid & (v >= bound32(lo)) & (v <= bound32(hi))
        return (qual.sum(dtype=torch.int32),
                torch.tensor(keys.shape[0], dtype=torch.int32,
                             device=keys.device))

    @staticmethod
    def nbytes() -> int:
        return 0
