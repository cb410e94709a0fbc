"""bucketize wrapper: the complete-histogram probe (paper section 4.2).

``bucketize_values(values (N,) f32, bounds (H+1,) f32, resolution,
nan_last=True) -> (N,) int32`` bucket ids in [0, H), clamped at the domain
edges. The build (``core.grouping.page_bucket_bits``) and the maintenance
paths (through ``core.histogram.bucketize``) take the default.
``bucketize_rows(values (N,), bounds (S, H+1), ...) -> (S, N) int32`` is
the same probe under each of S bounds rows in one launch.
``bucketize_rows_words(los, his, nonempty (Q,), bounds (S, H+1), ...) ->
(S, Q, ceil(H/32)) int32`` is that probe of each interval's two endpoints
packed into its query bitmap in the same launch: predicate conversion
(``core.predicate.interval_bitmaps_sharded``, and at S = 1
``interval_bitmaps``) takes it. A CPU tensor takes the plain version
(``ref``); a CUDA tensor launches ``csrc/bucketize.cu``. Both are bit-exact
against ``searchsorted(side="right") - 1`` for nondecreasing bounds: a NaN
value gets bucket H-1, where the reference's ``jnp.searchsorted`` sorts it;
with ``nan_last=False`` it gets bucket 0, the TPU kernel's formula.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bucketize import kernel
from repro_torch.kernels.bucketize.ref import (bucketize_ref,
                                               bucketize_rows_ref,
                                               bucketize_rows_words_ref)

_MAX_BOUNDS = 48 * 1024 // 4   # the bounds live in one block's shared memory
_MAX_ROWS = 65535              # the rows run on the grid's second axis


def _check(values: torch.Tensor, bounds: torch.Tensor, resolution: int,
           bounds_dim: int) -> None:
    if values.dtype != torch.float32 or bounds.dtype != torch.float32:
        raise TypeError(f"bucketize takes float32 values and bounds, got "
                        f"{values.dtype} and {bounds.dtype}")
    if values.dim() != 1 or bounds.dim() != bounds_dim:
        raise ValueError(f"bucketize takes 1-D values and {bounds_dim}-D "
                         f"bounds, got {tuple(values.shape)} and "
                         f"{tuple(bounds.shape)}")
    if not (values.is_contiguous() and bounds.is_contiguous()):
        raise ValueError("bucketize takes contiguous values and bounds")
    if values.device != bounds.device:
        raise ValueError(f"values on {values.device}, bounds on "
                         f"{bounds.device}")
    if not 1 <= resolution <= bounds.shape[-1] - 1:
        raise ValueError(f"resolution {resolution} does not fit "
                         f"{bounds.shape[-1]} bounds")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"bucketize runs on cpu or cuda, got {values.device}")
    if values.device.type == "cuda" and bounds.shape[-1] > _MAX_BOUNDS:
        raise ValueError(f"{bounds.shape[-1]} bounds exceed the kernel's "
                         f"{_MAX_BOUNDS} (shared memory)")


def bucketize_values(values: torch.Tensor, bounds: torch.Tensor,
                     resolution: int, nan_last: bool = True) -> torch.Tensor:
    _check(values, bounds, resolution, 1)
    if values.device.type == "cpu":
        return bucketize_ref(values, bounds, resolution, nan_last)
    out = torch.empty((values.numel(),), dtype=torch.int32,
                      device=values.device)
    if values.numel():
        kernel.launch(values, bounds, resolution, nan_last, out)
    return out


def bucketize_rows(values: torch.Tensor, bounds: torch.Tensor,
                   resolution: int, nan_last: bool = True) -> torch.Tensor:
    """Row s of the (S, N) ids is ``bucketize_values(values, bounds[s])``."""
    _check(values, bounds, resolution, 2)
    if values.device.type == "cpu":
        return bucketize_rows_ref(values, bounds, resolution, nan_last)
    if bounds.shape[0] > _MAX_ROWS:
        raise ValueError(f"{bounds.shape[0]} bounds rows exceed the kernel's "
                         f"{_MAX_ROWS} (grid)")
    out = torch.empty((bounds.shape[0], values.numel()), dtype=torch.int32,
                      device=values.device)
    if out.numel():
        kernel.launch_rows(values, bounds, resolution, nan_last, out)
    return out


def bucketize_rows_words(los: torch.Tensor, his: torch.Tensor,
                         nonempty: torch.Tensor, bounds: torch.Tensor,
                         resolution: int, nan_last: bool = True
                         ) -> torch.Tensor:
    """(S, Q, W) int32 query bitmaps: [s, q] holds bits [id(los[q]),
    id(his[q])], the ids ``bucketize_rows`` gives under ``bounds[s]``; all
    zero where ``nonempty[q]`` is False."""
    _check(los, bounds, resolution, 2)
    _check(his, bounds, resolution, 2)
    if (nonempty.dtype != torch.bool or nonempty.shape != los.shape
            or his.shape != los.shape or not nonempty.is_contiguous()
            or nonempty.device != los.device):
        raise ValueError(f"bucketize_rows_words takes los, his and a bool "
                         f"nonempty of one shape on one device, got "
                         f"{tuple(los.shape)}, {tuple(his.shape)} and "
                         f"{nonempty.dtype} {tuple(nonempty.shape)} on "
                         f"{nonempty.device}")
    if los.device.type == "cpu":
        return bucketize_rows_words_ref(los, his, nonempty, bounds,
                                        resolution, nan_last)
    if bounds.shape[0] > _MAX_ROWS:
        raise ValueError(f"{bounds.shape[0]} bounds rows exceed the kernel's "
                         f"{_MAX_ROWS} (grid)")
    out = torch.empty((bounds.shape[0], los.numel(),
                       (resolution + 31) // 32), dtype=torch.int32,
                      device=los.device)
    if out.numel():
        kernel.launch_rows_words(los, his, nonempty, bounds, resolution,
                                 nan_last, out)
    return out


__all__ = ["bucketize_values", "bucketize_rows", "bucketize_rows_words",
           "bucketize_ref", "bucketize_rows_ref", "bucketize_rows_words_ref"]
