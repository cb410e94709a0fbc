"""Roofline (port of ``repro.roofline``): the reference's per-kernel cost
models and roofline statement against the card's hardware rows."""
from repro_torch.roofline.analysis import (  # noqa: F401
    H100_SXM, KERNELS, Hardware, KernelCost, hardware, measure_cpu_stream,
    measure_cuda_stream, roofline, roofline_from_traffic,
)
