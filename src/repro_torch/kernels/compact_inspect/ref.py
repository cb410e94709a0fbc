"""Plain PyTorch version of the gathered-slab inspection.

Gathers the selected pages of every shard into an (S, M, C) slab (pad
selections, ``sel >= P``, gather page 0 and are masked invalid, the
reference's ``mode="fill"`` gather made explicit), then counts the tuples of
each (query, slab page) pair that are valid, selected for the query and
inside its interval — a few queries at a time so the (S, q, M, C) test stays
small. It is the CPU path of ``ops.compact_inspect`` and the CUDA kernel's
oracle.
"""
from __future__ import annotations

import torch

_CHUNK_ELEMS = 1 << 26


def compact_inspect_ref(keys: torch.Tensor, valid: torch.Tensor,
                        sel: torch.Tensor, sel_mask: torch.Tensor,
                        los: torch.Tensor, his: torch.Tensor) -> torch.Tensor:
    """keys (S, P, C) f32; valid (S, P, C) bool; sel (S, M) int32; sel_mask
    (S, Q, M) bool; los/his (Q,) f32 -> counts (S, Q, M) int32."""
    s, p, c = keys.shape
    m = sel.shape[1]
    q = sel_mask.shape[1]
    out = torch.zeros((s, q, m), dtype=torch.int32, device=keys.device)
    if p == 0:
        return out
    in_range = (sel >= 0) & (sel < p)
    idx = torch.where(in_range, sel, 0).long()[:, :, None].expand(s, m, c)
    slab_k = torch.gather(keys, 1, idx)                          # (S, M, C)
    slab_v = torch.gather(valid, 1, idx) & in_range[:, :, None]
    step = max(1, _CHUNK_ELEMS // max(1, s * m * c))
    for i in range(0, q, step):
        lo = los[i:i + step].view(1, -1, 1, 1)
        hi = his[i:i + step].view(1, -1, 1, 1)
        k = slab_k[:, None]
        qual = (sel_mask[:, i:i + step, :, None] & slab_v[:, None]
                & (k >= lo) & (k <= hi))
        out[:, i:i + step] = qual.sum(dim=-1, dtype=torch.int32)
    return out
