"""Plain PyTorch versions of the page inspection.

``page_inspect_ref`` is the TPU kernel's function: ``qual = mask[:, None] &
valid & (lo <= keys <= hi)`` and its per-page counts. ``page_inspect_many_ref``
counts the same test per (shard, query) over a batch of intervals, a few
queries at a time so the (S, q, P, C) test stays small (it never holds the
whole (S, Q, P, C) tuple mask). They are the CPU paths of ``ops`` and the
CUDA kernels' oracles.
"""
from __future__ import annotations

import torch

_CHUNK_ELEMS = 1 << 26


def page_inspect_ref(keys: torch.Tensor, valid: torch.Tensor,
                     mask: torch.Tensor, lo, hi
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """keys (P, C) f32; valid (P, C) bool; mask (P,) bool; lo/hi f32 scalars
    -> (qual (P, C) bool, counts (P,) int32)."""
    qual = mask[:, None] & valid & (keys >= lo) & (keys <= hi)
    return qual, qual.sum(dim=1, dtype=torch.int32)


def page_inspect_many_ref(keys: torch.Tensor, valid: torch.Tensor,
                          page_mask: torch.Tensor, los: torch.Tensor,
                          his: torch.Tensor) -> torch.Tensor:
    """keys (S, P, C) f32; valid (S, P, C) bool; page_mask (S, Q, P) bool;
    los/his (Q,) f32 -> counts (S, Q) int32."""
    s, p, c = keys.shape
    q = page_mask.shape[1]
    out = torch.zeros((s, q), dtype=torch.int32, device=keys.device)
    step = max(1, _CHUNK_ELEMS // max(1, s * p * c))
    k = keys[:, None]
    v = valid[:, None]
    for i in range(0, q, step):
        lo = los[i:i + step].view(1, -1, 1, 1)
        hi = his[i:i + step].view(1, -1, 1, 1)
        qual = page_mask[:, i:i + step, :, None] & v & (k >= lo) & (k <= hi)
        out[:, i:i + step] = qual.sum(dim=(2, 3), dtype=torch.int32)
    return out
