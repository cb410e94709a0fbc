"""ctypes binding of the CUDA gathered-slab inspection
(``csrc/compact_inspect.cu``).

``launches`` counts the kernel launches made through ``launch``; nothing
else touches it, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/compact_inspect.cu"
REPLACES = "src/repro/kernels/compact_inspect/kernel.py:39"

TILE_PAGES = 32   # kTilePages in the source


def shared_bytes(page_card: int, num_queries: int) -> int:
    """Dynamic shared memory of one block (mirrors the source)."""
    return ((TILE_PAGES * page_card * 5 + 15) & ~15) + num_queries * 8


launches = 0


def launch(keys: torch.Tensor, valid: torch.Tensor, sel: torch.Tensor,
           sel_mask: torch.Tensor, los: torch.Tensor, his: torch.Tensor,
           out: torch.Tensor) -> None:
    """keys (S, P, C) f32, valid (S, P, C) bool, sel (S, M) int32, sel_mask
    (S, Q, M) bool, los/his (Q,) f32, out (S, Q, M) int32, all contiguous on
    one CUDA device (``ops`` checks)."""
    global launches
    s, p, c = keys.shape
    m = sel.shape[1]
    q = sel_mask.shape[1]
    lib = _build.library()
    err = lib.hippo_compact_inspect(
        keys.data_ptr(), valid.data_ptr(), sel.data_ptr(),
        sel_mask.data_ptr(), los.data_ptr(), his.data_ptr(), s, p, c, m, q,
        out.data_ptr(), _build.stream_of(keys))
    _build.check(err, "compact_inspect")
    launches += 1
