"""batch_filter wrappers: the fused joint-bucket filter of the batched paths.

``batch_filter_sharded(queries (S, Q, W) int32, entries (S, E, W) int32,
live (S, E) bool) -> (S, Q, E) bool`` — every query bitmap of shard s
(converted under shard s's bounds) against every entry bitmap of shard s,
with the live-slot mask fused in (the compact path, the fused dense path and
the routing summary test). ``batch_filter(queries (Q, W), entries (E, W),
live (E,)) -> (Q, E) bool`` is the unsharded form (``search_many``). Packed
words are int32 holding the reference's uint32 bits (``core.bitmap``). A CPU
tensor takes the plain version (``ref``); a CUDA tensor launches
``csrc/batch_filter.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.batch_filter import kernel
from repro_torch.kernels.batch_filter.ref import (batch_filter_ref,
                                                  batch_filter_sharded_ref)

_MAX_WORDS = 32   # the kernel's tensor-core product: at most 4 k-steps


def _check(queries: torch.Tensor, entries: torch.Tensor,
           live: torch.Tensor) -> None:
    if queries.dtype != torch.int32 or entries.dtype != torch.int32:
        raise TypeError(f"batch_filter takes int32 words, got "
                        f"{queries.dtype} and {entries.dtype}")
    if live.dtype != torch.bool:
        raise TypeError(f"batch_filter takes a bool live mask, got {live.dtype}")
    if entries.shape[:-2] != queries.shape[:-2] \
            or entries.shape[-1] != queries.shape[-1]:
        raise ValueError(f"entries {tuple(entries.shape)} do not match "
                         f"queries {tuple(queries.shape)}")
    if tuple(live.shape) != tuple(entries.shape[:-1]):
        raise ValueError(f"live {tuple(live.shape)} does not match entries "
                         f"{tuple(entries.shape)}")
    if not (queries.is_contiguous() and entries.is_contiguous()
            and live.is_contiguous()):
        raise ValueError("batch_filter takes contiguous tensors")
    if not queries.device == entries.device == live.device:
        raise ValueError("batch_filter takes tensors on one device")
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"batch_filter runs on cpu or cuda, got "
                         f"{queries.device}")
    if queries.device.type == "cuda" and queries.shape[-1] > _MAX_WORDS:
        raise ValueError(f"{queries.shape[-1]} words per bitmap exceed the "
                         f"kernel's {_MAX_WORDS} (resolution <= 1024)")


def batch_filter_sharded(queries: torch.Tensor, entries: torch.Tensor,
                         live: torch.Tensor) -> torch.Tensor:
    if queries.dim() != 3 or entries.dim() != 3 or live.dim() != 2:
        raise ValueError("batch_filter_sharded takes queries (S, Q, W), "
                         "entries (S, E, W) and live (S, E)")
    _check(queries, entries, live)
    if queries.device.type == "cpu":
        return batch_filter_sharded_ref(queries, entries, live)
    s, q, _ = queries.shape
    out = torch.empty((s, q, entries.shape[1]), dtype=torch.bool,
                      device=queries.device)
    if out.numel():
        kernel.launch_sharded(queries, entries, live, out)
    return out


def batch_filter(queries: torch.Tensor, entries: torch.Tensor,
                 live: torch.Tensor) -> torch.Tensor:
    if queries.dim() != 2 or entries.dim() != 2 or live.dim() != 1:
        raise ValueError("batch_filter takes queries (Q, W), entries (E, W) "
                         "and live (E,)")
    _check(queries, entries, live)
    if queries.device.type == "cpu":
        return batch_filter_ref(queries, entries, live)
    out = torch.empty((queries.shape[0], entries.shape[0]), dtype=torch.bool,
                      device=queries.device)
    if out.numel():
        kernel.launch(queries, entries, live, out)
    return out


__all__ = ["batch_filter", "batch_filter_ref", "batch_filter_sharded",
           "batch_filter_sharded_ref"]
