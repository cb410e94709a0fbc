"""ctypes binding of the CUDA bucket probe (``csrc/bucketize.cu``) and its
launch counter ``KERNEL``, which counts both entry points."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

KERNEL = _build.Kernel("hippo_bucketize", "src/repro_torch/csrc/bucketize.cu",
                       "src/repro/kernels/bucketize/kernel.py:40")


def launch(values: torch.Tensor, bounds: torch.Tensor, resolution: int,
           nan_last: bool, out: torch.Tensor) -> None:
    """values (N,) f32, bounds (H+1,) f32, out (N,) int32, all contiguous on
    one CUDA device (the wrapper in ``ops`` checks)."""
    KERNEL.launch(values.data_ptr(), values.numel(), bounds.data_ptr(),
                  bounds.numel(), resolution, int(nan_last), out.data_ptr(),
                  on=values)


def launch_rows(values: torch.Tensor, bounds: torch.Tensor, resolution: int,
                nan_last: bool, out: torch.Tensor) -> None:
    """values (N,) f32, bounds (S, H+1) f32, out (S, N) int32, all
    contiguous on one CUDA device: row s of out under row s of bounds."""
    KERNEL.launch(values.data_ptr(), values.numel(), bounds.data_ptr(),
                  bounds.shape[0], bounds.shape[1], resolution, int(nan_last),
                  out.data_ptr(), on=values, entry="hippo_bucketize_rows")
