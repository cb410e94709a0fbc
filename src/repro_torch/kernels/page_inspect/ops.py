"""page_inspect wrappers: exact inspection of the possible qualified pages
(section 3.3, Algorithm 1 step 3).

``page_inspect(keys (P, C) f32, valid (P, C) bool, mask (P,) bool, lo, hi)
-> (qual (P, C) bool, counts (P,) int32)`` is the TPU kernel's contract and
serves the single-query ``search``. ``page_inspect_many(keys (S, P, C),
valid (S, P, C), page_mask (S, Q, P) bool, los (Q,), his (Q,)) -> (S, Q)
int32`` is the same test with a shard and a query axis, summed per (shard,
query); it serves ``search_many`` (S=1) and ``search_many_sharded`` and never
forms the (Q, P, C) tuple mask. ``lo``/``hi`` are float32 scalars: Python
floats or 0-d tensors (finite, as ``core.predicate`` clamps them). A CPU
tensor takes the plain version (``ref``); a CUDA tensor launches
``csrc/page_inspect.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.page_inspect import kernel
from repro_torch.kernels.page_inspect.ref import (page_inspect_many_ref,
                                                  page_inspect_ref)

_MAX_CARD = 1 << 20   # a block's tile of 64 pages indexes with int32


def _check_table(keys: torch.Tensor, valid: torch.Tensor) -> None:
    if keys.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"page_inspect takes float32 keys and bool valid, "
                        f"got {keys.dtype} and {valid.dtype}")
    if tuple(valid.shape) != tuple(keys.shape):
        raise ValueError(f"valid {tuple(valid.shape)} does not match keys "
                         f"{tuple(keys.shape)}")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"page_inspect runs on cpu or cuda, got "
                         f"{keys.device}")
    if keys.device.type == "cuda" and keys.shape[-1] > _MAX_CARD:
        raise ValueError(f"page_card {keys.shape[-1]} exceeds the kernel's "
                         f"{_MAX_CARD}")


def _scalar(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())


def page_inspect(keys: torch.Tensor, valid: torch.Tensor, mask: torch.Tensor,
                 lo, hi) -> tuple[torch.Tensor, torch.Tensor]:
    _check_table(keys, valid)
    if keys.dim() != 2 or mask.dtype != torch.bool \
            or tuple(mask.shape) != (keys.shape[0],):
        raise ValueError(f"page_inspect takes keys (P, C) and a bool mask "
                         f"(P,), got {tuple(keys.shape)} and "
                         f"{tuple(mask.shape)} {mask.dtype}")
    if not all(t.is_contiguous() for t in (keys, valid, mask)):
        raise ValueError("page_inspect takes contiguous tensors")
    if not keys.device == valid.device == mask.device:
        raise ValueError("page_inspect takes tensors on one device")
    lo, hi = _scalar(lo, keys.device), _scalar(hi, keys.device)
    if keys.device.type == "cpu":
        return page_inspect_ref(keys, valid, mask, lo, hi)
    p, c = keys.shape
    qual = torch.empty((p, c), dtype=torch.bool, device=keys.device)
    counts = torch.empty((p,), dtype=torch.int32, device=keys.device)
    if qual.numel():
        kernel.launch(keys, valid, mask, torch.stack([lo, hi]), qual, counts)
    else:
        counts.zero_()
    return qual, counts


def page_inspect_many(keys: torch.Tensor, valid: torch.Tensor,
                      page_mask: torch.Tensor, los: torch.Tensor,
                      his: torch.Tensor) -> torch.Tensor:
    _check_table(keys, valid)
    if keys.dim() != 3 or page_mask.dim() != 3:
        raise ValueError("page_inspect_many takes keys (S, P, C) and "
                         "page_mask (S, Q, P)")
    s, p, c = keys.shape
    q = page_mask.shape[1]
    if page_mask.dtype != torch.bool \
            or tuple(page_mask.shape) != (s, q, p):
        raise ValueError(f"page_mask {tuple(page_mask.shape)} "
                         f"{page_mask.dtype} does not match keys "
                         f"{tuple(keys.shape)}")
    if los.dtype != torch.float32 or his.dtype != torch.float32 \
            or tuple(los.shape) != (q,) or tuple(his.shape) != (q,):
        raise ValueError(f"los/his must be float32 ({q},)")
    tensors = (keys, valid, page_mask, los, his)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("page_inspect_many takes contiguous tensors")
    if any(t.device != keys.device for t in tensors):
        raise ValueError("page_inspect_many takes tensors on one device")
    if keys.device.type == "cpu":
        return page_inspect_many_ref(keys, valid, page_mask, los, his)
    if s > 65535:
        raise ValueError(f"{s} shards exceed the kernel's grid")
    m = kernel.MAX_QUERIES
    if q > m:
        return torch.cat([page_inspect_many(keys, valid,
                                            page_mask[:, i:i + m].contiguous(),
                                            los[i:i + m], his[i:i + m])
                          for i in range(0, q, m)], dim=1)
    out = torch.zeros((s, q), dtype=torch.int32, device=keys.device)
    if out.numel() and p * c:
        kernel.launch_many(keys, valid, page_mask, los, his, out)
    return out


__all__ = ["page_inspect", "page_inspect_many", "page_inspect_many_ref",
           "page_inspect_ref"]
