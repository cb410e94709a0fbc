"""Hand-written Hopper kernels for Hippo's hot spots.

Each kernel directory keeps the reference's three-file split:
  kernel.py — ctypes binding of the CUDA source in ``repro_torch/csrc`` and
              the kernel's launch counter
  ops.py    — the wrapper: checks device, dtype, shape and contiguity,
              allocates outputs, and dispatches on the tensor's device (CPU ->
              plain version, CUDA -> kernel; no fallback)
  ref.py    — the plain PyTorch version: the CPU path and the kernel's oracle

Kernels of the main path:
  bucketize       — histogram probe (build and predicate conversion)
  batch_filter    — sharded joint-bucket filter with the live mask fused
  compact_inspect — filter-match x interval count over the gathered slab
"""
from __future__ import annotations

from repro_torch.kernels.batch_filter import kernel as _batch_filter
from repro_torch.kernels.bucketize import kernel as _bucketize
from repro_torch.kernels.compact_inspect import kernel as _compact_inspect

KERNELS = {
    "bucketize": _bucketize,
    "batch_filter": _batch_filter,
    "compact_inspect": _compact_inspect,
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
