"""ctypes binding of the CUDA bucket probe (``csrc/bucketize.cu``) and its
launch counter ``KERNEL``, which counts every entry point;
``launch_rows_words.launches`` counts the words entry's launches alone."""
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


def launch_rows_words(los: torch.Tensor, his: torch.Tensor,
                      nonempty: torch.Tensor, bounds: torch.Tensor,
                      resolution: int, nan_last: bool, out: torch.Tensor
                      ) -> None:
    """los, his (Q,) f32, nonempty (Q,) bool, bounds (S, H+1) f32, out
    (S, Q, ceil(resolution / 32)) int32, all contiguous on one CUDA device:
    out[s, q] is the query bitmap of [los[q], his[q]] under row s of
    bounds, zero where nonempty[q] is False."""
    KERNEL.launch(los.data_ptr(), his.data_ptr(), nonempty.data_ptr(),
                  los.numel(), bounds.data_ptr(), bounds.shape[0],
                  bounds.shape[1], resolution, int(nan_last), out.data_ptr(),
                  on=los, entry="hippo_bucketize_rows_words")
    launch_rows_words.launches += 1


launch_rows_words.launches = 0
