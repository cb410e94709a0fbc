"""compact_inspect wrapper: the fused inspect phase of the compact path.

``compact_inspect(keys (S, P, C) f32, valid (S, P, C) bool, sel (S, M)
int32, sel_mask (S, Q, M) bool, los (Q,) f32, his (Q,) f32) -> counts
(S, Q, M) int32``. ``sel[s]`` lists the M slab pages of shard s in
ascending page order, padded with P; ``sel_mask[s, q, m]`` is query q's
filter match on slab page m. ``counts[s, q].sum()`` is query q's exact count
over shard s's slab. The pages are read through ``sel``: no slab copy is
made. A CPU tensor takes the plain version (``ref``); a CUDA tensor launches
``csrc/compact_inspect.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.compact_inspect import kernel
from repro_torch.kernels.compact_inspect.ref import compact_inspect_ref

_MAX_CARD = 1 << 20   # a block's tile of 32 pages indexes with int32


def compact_inspect(keys: torch.Tensor, valid: torch.Tensor,
                    sel: torch.Tensor, sel_mask: torch.Tensor,
                    los: torch.Tensor, his: torch.Tensor) -> torch.Tensor:
    if keys.dtype != torch.float32 or los.dtype != torch.float32 \
            or his.dtype != torch.float32:
        raise TypeError("compact_inspect takes float32 keys and intervals")
    if valid.dtype != torch.bool or sel_mask.dtype != torch.bool:
        raise TypeError("compact_inspect takes bool valid and sel_mask")
    if sel.dtype != torch.int32:
        raise TypeError(f"compact_inspect takes int32 sel, got {sel.dtype}")
    if keys.dim() != 3 or sel.dim() != 2 or sel_mask.dim() != 3:
        raise ValueError("compact_inspect takes keys (S, P, C), sel (S, M) "
                         "and sel_mask (S, Q, M)")
    s, p, c = keys.shape
    m = sel.shape[1]
    q = sel_mask.shape[1]
    if tuple(valid.shape) != tuple(keys.shape):
        raise ValueError(f"valid {tuple(valid.shape)} does not match keys "
                         f"{tuple(keys.shape)}")
    if sel.shape[0] != s or tuple(sel_mask.shape) != (s, q, m):
        raise ValueError(f"sel {tuple(sel.shape)} / sel_mask "
                         f"{tuple(sel_mask.shape)} do not match S={s}")
    if tuple(los.shape) != (q,) or tuple(his.shape) != (q,):
        raise ValueError(f"los/his must be ({q},)")
    tensors = (keys, valid, sel, sel_mask, los, his)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("compact_inspect takes contiguous tensors")
    if any(t.device != keys.device for t in tensors):
        raise ValueError("compact_inspect takes tensors on one device")
    if keys.device.type == "cpu":
        return compact_inspect_ref(keys, valid, sel, sel_mask, los, his)
    if keys.device.type != "cuda":
        raise ValueError(f"compact_inspect runs on cpu or cuda, got "
                         f"{keys.device}")
    if c > _MAX_CARD:
        raise ValueError(f"page_card {c} exceeds the kernel's {_MAX_CARD}")
    n = kernel.MAX_QUERIES
    if q > n:
        return torch.cat([compact_inspect(keys, valid, sel,
                                          sel_mask[:, i:i + n].contiguous(),
                                          los[i:i + n], his[i:i + n])
                          for i in range(0, q, n)], dim=1)
    out = torch.empty((s, q, m), dtype=torch.int32, device=keys.device)
    if out.numel():
        kernel.launch(keys, valid, sel, sel_mask, los, his, out)
    return out


__all__ = ["compact_inspect", "compact_inspect_ref"]
