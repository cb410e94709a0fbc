"""batch_filter wrapper: the fused joint-bucket filter of the compact path.

``batch_filter_sharded(queries (S, Q, W) int32, entries (S, E, W) int32,
live (S, E) bool) -> (S, Q, E) bool`` — every query bitmap of shard s
(converted under shard s's bounds) against every entry bitmap of shard s,
with the live-slot mask fused in. Packed words are int32 holding the
reference's uint32 bits (``core.bitmap``). A CPU tensor takes the plain
version (``ref``); a CUDA tensor launches ``csrc/batch_filter.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.batch_filter import kernel
from repro_torch.kernels.batch_filter.ref import batch_filter_sharded_ref

_MAX_WORDS = 32   # the kernel keeps an entry's words in registers


def batch_filter_sharded(queries: torch.Tensor, entries: torch.Tensor,
                         live: torch.Tensor) -> torch.Tensor:
    if queries.dtype != torch.int32 or entries.dtype != torch.int32:
        raise TypeError(f"batch_filter takes int32 words, got "
                        f"{queries.dtype} and {entries.dtype}")
    if live.dtype != torch.bool:
        raise TypeError(f"batch_filter takes a bool live mask, got {live.dtype}")
    if queries.dim() != 3 or entries.dim() != 3 or live.dim() != 2:
        raise ValueError("batch_filter takes queries (S, Q, W), entries "
                         "(S, E, W) and live (S, E)")
    s, q, w = queries.shape
    if entries.shape[0] != s or entries.shape[2] != w:
        raise ValueError(f"entries {tuple(entries.shape)} do not match "
                         f"queries {tuple(queries.shape)}")
    if tuple(live.shape) != tuple(entries.shape[:2]):
        raise ValueError(f"live {tuple(live.shape)} does not match entries "
                         f"{tuple(entries.shape)}")
    if not (queries.is_contiguous() and entries.is_contiguous()
            and live.is_contiguous()):
        raise ValueError("batch_filter takes contiguous tensors")
    if not queries.device == entries.device == live.device:
        raise ValueError("batch_filter takes tensors on one device")
    if queries.device.type == "cpu":
        return batch_filter_sharded_ref(queries, entries, live)
    if queries.device.type != "cuda":
        raise ValueError(f"batch_filter runs on cpu or cuda, got "
                         f"{queries.device}")
    if w > _MAX_WORDS:
        raise ValueError(f"{w} words per bitmap exceed the kernel's "
                         f"{_MAX_WORDS} (resolution <= 1024)")
    out = torch.empty((s, q, entries.shape[1]), dtype=torch.bool,
                      device=queries.device)
    if out.numel():
        kernel.launch(queries, entries, live, out)
    return out


__all__ = ["batch_filter_sharded", "batch_filter_sharded_ref"]
