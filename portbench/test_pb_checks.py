"""The check that no JAX is loaded compares whole top-level names."""
from pb_checks import forbidden_modules


def test_catches_the_jax_package_and_jax():
    assert forbidden_modules(["repro", "numpy"]) == ["repro"]
    assert forbidden_modules(["repro.core.index"]) == ["repro"]
    assert forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen"]) \
        == ["flax", "jax", "jaxlib"]


def test_passes_the_port():
    names = ["repro_torch", "repro_torch.core.index", "reprolib", "jaxtyping",
             "torch", "numpy"]
    assert forbidden_modules(names) == []
