from repro_torch.kernels.batch_filter.ops import batch_filter_sharded  # noqa: F401
