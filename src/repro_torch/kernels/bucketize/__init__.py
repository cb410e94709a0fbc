from repro_torch.kernels.bucketize.ops import bucketize_values  # noqa: F401
