"""The check that the process holds no JAX: by whole top-level module names,
since the port's package (``repro_torch``) begins with the JAX package's
name (``repro``)."""
from __future__ import annotations

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names) -> list[str]:
    """The forbidden top-level names among module names ``names``."""
    tops = {str(n).split(".", 1)[0] for n in names}
    return sorted(tops.intersection(FORBIDDEN))
