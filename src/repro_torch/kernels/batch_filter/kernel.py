"""ctypes bindings of the CUDA joint-bucket filters (``csrc/batch_filter.cu``).

Two entry points of one kernel, each with its own launch counter:
``SHARDED`` (the TPU's ``batch_filter_sharded_kernel``, the compact path and
the fused dense path) and ``UNSHARDED`` (the TPU's ``batch_filter_kernel``,
``search_many``: the HippoIndex batch and every routed per-shard dispatch).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/batch_filter.cu"

SHARDED = _build.Kernel("hippo_batch_filter_sharded", SOURCE,
                        "src/repro/kernels/batch_filter/kernel.py:59")
UNSHARDED = _build.Kernel("hippo_batch_filter", SOURCE,
                          "src/repro/kernels/batch_filter/kernel.py:32")


def launch_sharded(queries: torch.Tensor, entries: torch.Tensor,
                   live: torch.Tensor, out: torch.Tensor) -> None:
    """queries (S, Q, W) int32, entries (S, E, W) int32, live (S, E) bool,
    out (S, Q, E) bool, all contiguous on one CUDA device (``ops`` checks)."""
    s, q, w = queries.shape
    SHARDED.launch(queries.data_ptr(), entries.data_ptr(), live.data_ptr(),
                   s, q, entries.shape[1], w, out.data_ptr(), on=queries)


def launch(queries: torch.Tensor, entries: torch.Tensor, live: torch.Tensor,
           out: torch.Tensor) -> None:
    """queries (Q, W) int32, entries (E, W) int32, live (E,) bool, out (Q, E)
    bool, all contiguous on one CUDA device (``ops`` checks)."""
    q, w = queries.shape
    UNSHARDED.launch(queries.data_ptr(), entries.data_ptr(), live.data_ptr(),
                     q, entries.shape[0], w, out.data_ptr(), on=queries)
