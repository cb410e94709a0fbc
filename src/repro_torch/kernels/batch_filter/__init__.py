from repro_torch.kernels.batch_filter.ops import (batch_filter,  # noqa: F401
                                                  batch_filter_sharded)
