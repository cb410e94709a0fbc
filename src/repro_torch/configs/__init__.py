"""Arch registry — importing this package registers every assigned config.

A copy of ``repro.configs``, which uses no framework: the port keeps its own
so that it imports nothing of the JAX package.
"""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ModelConfig, ShapeConfig, get_config, list_archs, register,
    shape_cells,
)
from repro_torch.configs import archs  # noqa: F401  (registers all architectures)
from repro_torch.configs import hippo_default  # noqa: F401
