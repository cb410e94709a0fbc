"""Hand-written Hopper kernels for Hippo's hot spots.

Each kernel directory keeps the reference's three-file split:
  kernel.py — ctypes binding of the CUDA source in ``repro_torch/csrc`` and
              the launch counter of each entry point (``_build.Kernel``)
  ops.py    — the wrapper: checks device, dtype, shape and contiguity,
              allocates outputs, and dispatches on the tensor's device (CPU ->
              plain version, CUDA -> kernel; no fallback)
  ref.py    — the plain PyTorch version: the CPU path and the kernel's oracle

Kernels, by the name their launches are counted under:
  bucketize              — histogram probe (build and predicate conversion)
  bucketize_rows_words   — its words entry alone (predicate conversion),
                           counted under ``bucketize`` too
  batch_filter           — sharded joint-bucket filter, live mask fused
                           (compact path, fused dense path, routing test)
  batch_filter_unsharded — the same filter without a shard axis
                           (``search_many``: HippoIndex batches, routed
                           per-shard dispatches)
  compact_inspect        — filter-match x interval count over the slab
  bitmap_and             — single-query joint-bucket filter (``search``)
  page_inspect           — single-query tuple mask and page counts
                           (``search``)
  page_inspect_many      — per-(shard, query) counts over the page masks
                           (``search_many``, ``search_many_sharded``)
"""
from __future__ import annotations

from repro_torch.kernels.batch_filter import kernel as _batch_filter
from repro_torch.kernels.bitmap_and import kernel as _bitmap_and
from repro_torch.kernels.bucketize import kernel as _bucketize
from repro_torch.kernels.compact_inspect import kernel as _compact_inspect
from repro_torch.kernels.page_inspect import kernel as _page_inspect

KERNELS = {
    "bucketize": _bucketize.KERNEL,
    "batch_filter": _batch_filter.SHARDED,
    "batch_filter_unsharded": _batch_filter.UNSHARDED,
    "compact_inspect": _compact_inspect.KERNEL,
    "bitmap_and": _bitmap_and.KERNEL,
    "page_inspect": _page_inspect.SINGLE,
    "page_inspect_many": _page_inspect.MANY,
}


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last ``reset_launch_counts``."""
    return {**{name: k.launches for name, k in KERNELS.items()},
            "bucketize_rows_words": _bucketize.launch_rows_words.launches}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0
    _bucketize.launch_rows_words.launches = 0
