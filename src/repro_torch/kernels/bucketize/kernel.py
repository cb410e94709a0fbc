"""ctypes binding of the CUDA bucket probe (``csrc/bucketize.cu``).

``launches`` counts the kernel launches made through ``launch``; nothing
else touches it, so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/bucketize.cu"
REPLACES = "src/repro/kernels/bucketize/kernel.py:40"

launches = 0


def launch(values: torch.Tensor, bounds: torch.Tensor, resolution: int,
           out: torch.Tensor) -> None:
    """values (N,) f32, bounds (H+1,) f32, out (N,) int32, all contiguous on
    one CUDA device (the wrapper in ``ops`` checks)."""
    global launches
    lib = _build.library()
    err = lib.hippo_bucketize(values.data_ptr(), values.numel(),
                              bounds.data_ptr(), bounds.numel(), resolution,
                              out.data_ptr(), _build.stream_of(values))
    _build.check(err, "bucketize")
    launches += 1
