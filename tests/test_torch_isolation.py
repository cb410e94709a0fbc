"""The PyTorch port stands alone: no JAX, no ``repro``, no silent CPU.

- Importing every ``repro_torch`` module in a fresh interpreter, without
  ``JAX_PLATFORMS``, loads neither ``jax`` nor any ``repro`` module.
- No source file of the port (nor ``chip_smoke.py``) imports either.
- Entry points given ``device=None`` raise when CUDA is absent instead of
  carrying on on the CPU, and ``chip_smoke.py`` exits nonzero with no result
  line there, and alone in a directory.
- A kernel wrapper takes its plain version only for CPU tensors: the CPU
  path never touches the kernel library.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.hippo import HippoIndex
from repro_torch.core.partition import ShardedHippoIndex
from repro_torch.core.predicate import intervals
from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels.bucketize import bucketize_values
from repro_torch.storage.table import PagedTable

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _port_modules() -> list[str]:
    mods = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(REPO / "src").with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name.startswith("jaxlib.") or name == "repro"
            or name.startswith("repro."))


def test_importing_every_port_module_loads_no_jax_and_no_repro():
    code = (
        "import importlib, sys\n"
        f"mods = {_port_modules()!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n in ('jax', 'jaxlib', 'repro')"
        " or n.startswith(('jax.', 'jaxlib.', 'repro.')))\n"
        "print(len(mods), bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"], ids=lambda p: p.name)
def test_port_sources_import_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


def test_device_none_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    table = PagedTable.from_values(np.arange(500, dtype=np.float32), 50)
    with pytest.raises(RuntimeError, match="CUDA"):
        table.device_keys()
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedHippoIndex.create(table, num_shards=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        HippoIndex.create(table)
    with pytest.raises(RuntimeError, match="CUDA"):
        intervals([], None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cpu_tensors_take_the_plain_version_without_the_library(monkeypatch):
    def no_library():
        raise AssertionError("the CPU path must not touch the kernel library")
    monkeypatch.setattr(_build, "library", no_library)
    ids = bucketize_values(torch.tensor([0.5, 2.5, 9.0]),
                           torch.tensor([0.0, 1.0, 2.0, 3.0]), 3)
    assert ids.tolist() == [0, 2, 2]


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
