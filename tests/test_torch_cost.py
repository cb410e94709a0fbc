"""The port's copy of the §6 cost model against the reference's, on the CPU.

``repro_torch.core.cost`` is host math copied from ``repro.core.cost``; every
formula must return the same float, bit for bit, on a grid of (card, H, D,
sf, page_card). Run:

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q tests/test_torch_cost.py
"""
import inspect
import itertools
import struct

import pytest

from repro.core import cost as ref
from repro_torch.core import cost as port

CARDS = (1, 2, 50, 200_000, 6_001_215, 59_986_052)
RESOLUTIONS = (1, 10, 16, 400, 1000, 10_000)
DENSITIES = (0.01, 0.1, 0.2, 0.5, 1.0)
SFS = (1e-6, 1e-5, 1e-3, 0.01, 0.2, 0.9, 1.0)
PAGE_CARDS = (1, 50, 128)
GRID = {"card": CARDS, "resolution": RESOLUTIONS, "density": DENSITIES,
        "sf": SFS, "page_card": PAGE_CARDS}
FUNCTIONS = sorted(name for name, f in inspect.getmembers(ref,
                                                          inspect.isfunction)
                   if f.__module__ == ref.__name__)


def _bits(x) -> bytes:
    return struct.pack("<d", float(x)) + type(x).__name__.encode()


def test_the_copy_has_every_formula():
    assert FUNCTIONS == sorted(
        name for name, f in inspect.getmembers(port, inspect.isfunction)
        if f.__module__ == port.__name__)
    assert len(FUNCTIONS) == 10


@pytest.mark.parametrize("name", FUNCTIONS)
def test_formula_equals_reference_on_the_grid(name):
    params = list(inspect.signature(getattr(ref, name)).parameters)
    assert params == list(inspect.signature(getattr(port, name)).parameters)
    cases = 0
    for args in itertools.product(*(GRID[p] for p in params)):
        want = getattr(ref, name)(*args)
        got = getattr(port, name)(*args)
        assert _bits(got) == _bits(want), (name, args, got, want)
        cases += 1
    assert cases >= 5


def test_paper_examples():
    # §6.1 Fig. 5: SF=20%, H=10, D=0.2 -> Prob = 40%; §6.2: H=1000, D=0.1
    # -> T ~ 105.3
    assert port.prob_inspect(0.2, 10, 0.2) == ref.prob_inspect(0.2, 10, 0.2)
    assert abs(port.prob_inspect(0.2, 10, 0.2) - 0.4) < 1e-12
    assert abs(port.tuples_per_entry(1000, 0.1) - 105.3) < 0.01 * 105.3
