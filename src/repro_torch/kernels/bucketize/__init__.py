from repro_torch.kernels.bucketize.ops import (  # noqa: F401
    bucketize_rows, bucketize_rows_words, bucketize_values)
