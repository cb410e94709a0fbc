"""ctypes binding of the CUDA gathered-slab inspection
(``csrc/compact_inspect.cu``) and its launch counter ``KERNEL``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

KERNEL = _build.Kernel("hippo_compact_inspect",
                       "src/repro_torch/csrc/compact_inspect.cu",
                       "src/repro/kernels/compact_inspect/kernel.py:39")

MAX_QUERIES = 1024   # kMaxQueries in csrc/page_count.cuh; ops splits more


def launch(keys: torch.Tensor, valid: torch.Tensor, sel: torch.Tensor,
           sel_mask: torch.Tensor, los: torch.Tensor, his: torch.Tensor,
           out: torch.Tensor) -> None:
    """keys (S, P, C) f32, valid (S, P, C) bool, sel (S, M) int32, sel_mask
    (S, Q, M) bool, los/his (Q,) f32, out (S, Q, M) int32, all contiguous on
    one CUDA device, Q <= MAX_QUERIES (``ops`` checks and splits larger
    batches)."""
    s, p, c = keys.shape
    KERNEL.launch(keys.data_ptr(), valid.data_ptr(), sel.data_ptr(),
                  sel_mask.data_ptr(), los.data_ptr(), his.data_ptr(), s, p,
                  c, sel.shape[1], sel_mask.shape[1], out.data_ptr(), on=keys)
