from repro_torch.kernels.page_inspect.ops import (page_inspect,  # noqa: F401
                                                  page_inspect_many)
