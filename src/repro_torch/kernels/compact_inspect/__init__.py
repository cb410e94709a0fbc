from repro_torch.kernels.compact_inspect.ops import compact_inspect  # noqa: F401
