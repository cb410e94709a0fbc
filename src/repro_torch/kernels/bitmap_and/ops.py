"""bitmap_and wrapper: the single-query joint-bucket filter (section 3.2).

``bitmap_and_any(entries (E, W) int32, query (W,) int32, live (E,) bool) ->
(E,) bool`` — True iff entry e is live and shares a set bucket bit with the
query bitmap (step 2 of the single-query ``search``). The live-slot mask is
fused in, as in ``batch_filter``. Packed words are int32 holding the
reference's uint32 bits (``core.bitmap``). A CPU tensor takes the plain
version (``ref``); a CUDA tensor launches ``csrc/bitmap_and.cu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bitmap_and import kernel
from repro_torch.kernels.bitmap_and.ref import bitmap_and_any_ref

_MAX_WORDS = 32   # the query lives in one block's shared memory


def bitmap_and_any(entries: torch.Tensor, query: torch.Tensor,
                   live: torch.Tensor) -> torch.Tensor:
    if entries.dtype != torch.int32 or query.dtype != torch.int32:
        raise TypeError(f"bitmap_and takes int32 words, got {entries.dtype} "
                        f"and {query.dtype}")
    if live.dtype != torch.bool:
        raise TypeError(f"bitmap_and takes a bool live mask, got {live.dtype}")
    if entries.dim() != 2 or query.dim() != 1 or live.dim() != 1:
        raise ValueError("bitmap_and takes entries (E, W), query (W,) and "
                         "live (E,)")
    e, w = entries.shape
    if query.shape[0] != w or live.shape[0] != e:
        raise ValueError(f"query {tuple(query.shape)} / live "
                         f"{tuple(live.shape)} do not match entries "
                         f"{tuple(entries.shape)}")
    if not (entries.is_contiguous() and query.is_contiguous()
            and live.is_contiguous()):
        raise ValueError("bitmap_and takes contiguous tensors")
    if not entries.device == query.device == live.device:
        raise ValueError("bitmap_and takes tensors on one device")
    if entries.device.type == "cpu":
        return bitmap_and_any_ref(entries, query, live)
    if entries.device.type != "cuda":
        raise ValueError(f"bitmap_and runs on cpu or cuda, got "
                         f"{entries.device}")
    if not 1 <= w <= _MAX_WORDS:
        raise ValueError(f"{w} words per bitmap: the kernel takes 1 to "
                         f"{_MAX_WORDS} (resolution <= 1024)")
    out = torch.empty((e,), dtype=torch.bool, device=entries.device)
    if e:
        kernel.launch(entries, query, live, out)
    return out


__all__ = ["bitmap_and_any", "bitmap_and_any_ref"]
