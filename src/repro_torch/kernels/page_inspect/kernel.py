"""ctypes bindings of the CUDA page inspection (``csrc/page_inspect.cu``).

Two entry points, each with its own launch counter: ``SINGLE`` (the TPU
kernel's contract: one interval, the qualifying tuple mask and per-page
counts; the single-query ``search``) and ``MANY`` (per-(shard, query)
counts over a batch of intervals; ``search_many`` and
``search_many_sharded``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/page_inspect.cu"
REPLACES = "src/repro/kernels/page_inspect/kernel.py:35"

SINGLE = _build.Kernel("hippo_page_inspect", SOURCE, REPLACES)
MANY = _build.Kernel("hippo_page_inspect_many", SOURCE, REPLACES)

MAX_QUERIES = 1024   # kMaxQueries in csrc/page_count.cuh; ops splits more


def launch(keys: torch.Tensor, valid: torch.Tensor, mask: torch.Tensor,
           interval: torch.Tensor, qual: torch.Tensor,
           counts: torch.Tensor) -> None:
    """keys (P, C) f32, valid (P, C) bool, mask (P,) bool, interval (2,) f32,
    qual (P, C) bool, counts (P,) int32, all contiguous on one CUDA device
    (``ops`` checks)."""
    p, c = keys.shape
    SINGLE.launch(keys.data_ptr(), valid.data_ptr(), mask.data_ptr(),
                  interval.data_ptr(), p, c, qual.data_ptr(),
                  counts.data_ptr(), on=keys)


def launch_many(keys: torch.Tensor, valid: torch.Tensor,
                page_mask: torch.Tensor, los: torch.Tensor, his: torch.Tensor,
                counts: torch.Tensor) -> None:
    """keys (S, P, C) f32, valid (S, P, C) bool, page_mask (S, Q, P) bool,
    los/his (Q,) f32, counts (S, Q) int32 zeroed, all contiguous on one CUDA
    device, Q <= MAX_QUERIES (``ops`` checks and splits larger batches)."""
    s, p, c = keys.shape
    MANY.launch(keys.data_ptr(), valid.data_ptr(), page_mask.data_ptr(),
                los.data_ptr(), his.data_ptr(), s, p, c, page_mask.shape[1],
                counts.data_ptr(), on=keys)
