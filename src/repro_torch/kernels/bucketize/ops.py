"""bucketize wrapper: the complete-histogram probe (paper section 4.2).

``bucketize_values(values (N,) f32, bounds (H+1,) f32, resolution,
nan_last=True) -> (N,) int32`` bucket ids in [0, H), clamped at the domain
edges. The build (``core.grouping.page_bucket_bits``), the maintenance paths
(through ``core.histogram.bucketize``) and predicate conversion
(``core.predicate.interval_bitmaps``) all take the default. A CPU tensor
takes the plain version (``ref``); a CUDA tensor launches
``csrc/bucketize.cu``. Both are bit-exact against
``searchsorted(side="right") - 1`` for nondecreasing bounds: a NaN value
gets bucket H-1, where the reference's ``jnp.searchsorted`` sorts it; with
``nan_last=False`` it gets bucket 0, the TPU kernel's formula.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bucketize import kernel
from repro_torch.kernels.bucketize.ref import bucketize_ref

_MAX_BOUNDS = 48 * 1024 // 4   # the bounds live in one block's shared memory


def bucketize_values(values: torch.Tensor, bounds: torch.Tensor,
                     resolution: int, nan_last: bool = True) -> torch.Tensor:
    if values.dtype != torch.float32 or bounds.dtype != torch.float32:
        raise TypeError(f"bucketize takes float32 values and bounds, got "
                        f"{values.dtype} and {bounds.dtype}")
    if values.dim() != 1 or bounds.dim() != 1:
        raise ValueError(f"bucketize takes 1-D values and bounds, got "
                         f"{tuple(values.shape)} and {tuple(bounds.shape)}")
    if not (values.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("bucketize takes contiguous values and bounds")
    if values.device != bounds.device:
        raise ValueError(f"values on {values.device}, bounds on "
                         f"{bounds.device}")
    if not 1 <= resolution <= bounds.numel() - 1:
        raise ValueError(f"resolution {resolution} does not fit "
                         f"{bounds.numel()} bounds")
    if values.device.type == "cpu":
        return bucketize_ref(values, bounds, resolution, nan_last)
    if values.device.type != "cuda":
        raise ValueError(f"bucketize runs on cpu or cuda, got {values.device}")
    if bounds.numel() > _MAX_BOUNDS:
        raise ValueError(f"{bounds.numel()} bounds exceed the kernel's "
                         f"{_MAX_BOUNDS} (shared memory)")
    out = torch.empty((values.numel(),), dtype=torch.int32,
                      device=values.device)
    if values.numel():
        kernel.launch(values, bounds, resolution, nan_last, out)
    return out


__all__ = ["bucketize_values", "bucketize_ref"]
