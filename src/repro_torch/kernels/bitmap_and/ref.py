"""Plain PyTorch version of the single-query joint-bucket filter.

``out[e] = live[e] & any_w(entries[e, w] & query[w] != 0)``. It is the CPU
path of ``ops.bitmap_and_any`` and the CUDA kernel's oracle.
"""
from __future__ import annotations

import torch


def bitmap_and_any_ref(entries: torch.Tensor, query: torch.Tensor,
                       live: torch.Tensor) -> torch.Tensor:
    """entries (E, W) int32; query (W,) int32; live (E,) bool -> (E,) bool."""
    return ((entries & query[None, :]) != 0).any(dim=1) & live
