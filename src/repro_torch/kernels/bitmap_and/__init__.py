from repro_torch.kernels.bitmap_and.ops import bitmap_and_any  # noqa: F401
