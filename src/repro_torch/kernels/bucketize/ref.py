"""Plain PyTorch version of the bucket probe: compare and count.

``ids = clip(#{bounds <= v} - 1, 0, H - 1)``, the TPU kernel's own formula,
in chunks of values so the (chunk, H+1) compare stays small; with
``nan_last`` (the default) a NaN value gets H - 1 instead of the formula's
0. It is the
CPU path of ``ops.bucketize_values`` and the CUDA kernel's oracle;
``bucketize_rows_ref`` applies it under each row of stacked bounds, the CPU
path of ``ops.bucketize_rows``; ``bucketize_rows_words_ref`` packs those ids
into query bitmaps, the CPU path of ``ops.bucketize_rows_words``.
"""
from __future__ import annotations

import torch

from repro_torch.core import bitmap as bm

_CHUNK_ELEMS = 1 << 24


def bucketize_ref(values: torch.Tensor, bounds: torch.Tensor,
                  resolution: int, nan_last: bool = True) -> torch.Tensor:
    """values (N,) f32; bounds (H+1,) f32 nondecreasing -> (N,) int32."""
    n = values.numel()
    out = torch.empty((n,), dtype=torch.int32, device=values.device)
    step = max(1, _CHUNK_ELEMS // max(1, bounds.numel()))
    for i in range(0, n, step):
        v = values[i:i + step]
        cnt = (v[:, None] >= bounds[None, :]).sum(dim=1)
        out[i:i + step] = (cnt - 1).clamp(0, resolution - 1).to(torch.int32)
    if nan_last:
        out[values.isnan()] = resolution - 1
    return out


def bucketize_rows_ref(values: torch.Tensor, bounds: torch.Tensor,
                       resolution: int, nan_last: bool = True
                       ) -> torch.Tensor:
    """values (N,) f32; bounds (S, H+1) f32, each row nondecreasing ->
    (S, N) int32: row s is ``bucketize_ref`` under ``bounds[s]``."""
    out = torch.empty((bounds.shape[0], values.numel()), dtype=torch.int32,
                      device=values.device)
    for s in range(bounds.shape[0]):
        out[s] = bucketize_ref(values, bounds[s], resolution, nan_last)
    return out


def bucketize_rows_words_ref(los: torch.Tensor, his: torch.Tensor,
                             nonempty: torch.Tensor, bounds: torch.Tensor,
                             resolution: int, nan_last: bool = True
                             ) -> torch.Tensor:
    """los, his (Q,) f32, nonempty (Q,) bool; bounds (S, H+1) f32 ->
    (S, Q, ceil(resolution / 32)) int32 query bitmaps: bits [id(lo), id(hi)]
    under each row, all zero where ``nonempty`` is False."""
    q = los.shape[0]
    ids = bucketize_rows_ref(torch.cat([los, his]), bounds, resolution,
                             nan_last)
    words = bm.range_mask(resolution, ids[:, :q], ids[:, q:])
    return torch.where(nonempty[None, :, None], words, 0)
