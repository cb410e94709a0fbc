"""ctypes binding of the CUDA single-query joint-bucket filter
(``csrc/bitmap_and.cu``) and its launch counter ``KERNEL``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

KERNEL = _build.Kernel("hippo_bitmap_and_any",
                       "src/repro_torch/csrc/bitmap_and.cu",
                       "src/repro/kernels/bitmap_and/kernel.py:29")


def launch(entries: torch.Tensor, query: torch.Tensor, live: torch.Tensor,
           out: torch.Tensor) -> None:
    """entries (E, W) int32, query (W,) int32, live (E,) bool, out (E,) bool,
    all contiguous on one CUDA device (``ops`` checks)."""
    e, w = entries.shape
    KERNEL.launch(entries.data_ptr(), query.data_ptr(), live.data_ptr(), e, w,
                  out.data_ptr(), on=entries)
