"""ctypes binding of the CUDA sharded joint-bucket filter
(``csrc/batch_filter.cu``).

``launches`` counts the kernel launches made through ``launch``; nothing
else touches it, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/batch_filter.cu"
REPLACES = "src/repro/kernels/batch_filter/kernel.py:59"

launches = 0


def launch(queries: torch.Tensor, entries: torch.Tensor, live: torch.Tensor,
           out: torch.Tensor) -> None:
    """queries (S, Q, W) int32, entries (S, E, W) int32, live (S, E) bool,
    out (S, Q, E) bool, all contiguous on one CUDA device (``ops`` checks)."""
    global launches
    s, q, w = queries.shape
    e = entries.shape[1]
    lib = _build.library()
    err = lib.hippo_batch_filter_sharded(
        queries.data_ptr(), entries.data_ptr(), live.data_ptr(), s, q, e, w,
        out.data_ptr(), _build.stream_of(queries))
    _build.check(err, "batch_filter_sharded")
    launches += 1
