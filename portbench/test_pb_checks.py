"""The check that no JAX is loaded compares whole top-level names, and the
refresh streams import nothing of the program or of JAX."""
import ast
from pathlib import Path

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


def test_streams_import_neither_the_program_nor_jax():
    streams = sorted((Path(__file__).parent / "streams").glob("*.py"))
    assert streams
    for path in streams:
        names = []
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names.append(node.module or "")
        assert not forbidden_modules(names), path
        assert not [n for n in names if n.split(".")[0] == "repro_torch"], path
