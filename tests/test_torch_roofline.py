"""The port's roofline (``repro_torch.roofline``) against the JAX package's,
in process (it needs no virtual devices).

The cost models and the roofline statement are copies, so their numbers are
equal exactly; the report prints the same table for the same hardware row.
Only the hardware table differs: the card's rows replace the TPU's.
"""
import json
import math
import os

import pytest

from repro import roofline as jrl
from repro.roofline import analysis as janalysis
from repro.roofline import report as jreport
from repro_torch import roofline as trl
from repro_torch.roofline import analysis as tanalysis
from repro_torch.roofline import report as treport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "BENCH_2026-08-09_pr9_quick.json")

# the reference test's shapes, small and ragged ones, and the SF10 shapes
# that chip_smoke's phase 4 prices
SHAPES = {
    "bitmap_and": [dict(e=65_536, w=13), dict(e=1, w=1), dict(e=1_023, w=7),
                   dict(e=1_500_676, w=13)],
    "batch_filter": [dict(q=64, e=16_384, w=13), dict(q=1, e=1, w=1),
                     dict(q=3, e=1_000, w=13, s=4),
                     dict(q=64, e=469_685, w=13, s=4),
                     dict(q=64, e=1_500_676, w=13)],
    "bucketize": [dict(n=1_048_576, h=400), dict(n=1, h=1),
                  dict(n=777, h=63), dict(n=18_746_450, h=400)],
    "page_inspect": [dict(p=16_384, c=128), dict(p=1, c=1),
                     dict(p=999, c=50), dict(p=1_199_722, c=50)],
    "compact_inspect": [dict(q=64, m=2_048, c=128), dict(q=1, m=1, c=1),
                        dict(q=7, m=300, c=50), dict(q=64, m=374_929, c=50),
                        dict(q=64, m=1_499_716, c=50)],
}
CASES = [(k, s) for k, shapes in SHAPES.items() for s in shapes]


def _row(module, name="probe"):
    return module.Hardware(name, mem_bw=2.5e12, vector_ops=60e12,
                           note="one row for both packages")


def _ref_tests_docs():
    """The reference's test documents (tests/test_roofline.py)."""
    return [
        {"suites": {"kernels": [
            {"name": "kernel_bitmap_and_64k", "us_per_call": 1500.0,
             "derived": {"bytes": 3_670_068, "ops": 1_703_936}},
            {"name": "no_traffic_row", "us_per_call": 3.0, "derived": {}},
        ]}},
        {"suites": {}},
        {"suites": {"kernels": [
            {"name": "kernel_bucketize_1m", "us_per_call": 28_000.0,
             "derived": {"bytes": 8_390_212, "ops": 9_437_184}}]}},
    ]


def test_kernel_registry_is_the_reference_one():
    assert list(trl.KERNELS) == list(jrl.KERNELS)


@pytest.mark.parametrize("kernel,shape", CASES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(CASES)])
def test_cost_models_equal_reference(kernel, shape):
    got, want = trl.KERNELS[kernel](**shape), jrl.KERNELS[kernel](**shape)
    assert (got.kernel, got.bytes_moved, got.ops) == \
        (want.kernel, want.bytes_moved, want.ops)
    assert got.arithmetic_intensity == want.arithmetic_intensity


@pytest.mark.parametrize("kernel,shape", CASES[::2],
                         ids=[f"{k}-{2 * i}" for i, (k, _)
                              in enumerate(CASES[::2])])
@pytest.mark.parametrize("seconds", [1e-6, 3.7e-4, 0.5])
def test_roofline_equals_reference_on_one_hardware_row(kernel, shape,
                                                       seconds):
    t_hw, j_hw = _row(tanalysis), _row(janalysis)
    assert t_hw.ridge_ai == j_hw.ridge_ai
    got = trl.roofline(trl.KERNELS[kernel](**shape), seconds, t_hw)
    want = jrl.roofline(jrl.KERNELS[kernel](**shape), seconds, j_hw)
    assert got == want
    c = trl.KERNELS[kernel](**shape)
    assert trl.roofline_from_traffic(c.bytes_moved, c.ops, seconds, t_hw) \
        == jrl.roofline_from_traffic(c.bytes_moved, c.ops, seconds, j_hw)


def test_roofline_refuses_a_nonpositive_time():
    with pytest.raises(ValueError):
        trl.roofline_from_traffic(1.0, 1.0, 0.0, trl.H100_SXM)


@pytest.mark.parametrize("which", ["test_docs", "pr9_quick"])
def test_build_table_equals_reference(monkeypatch, which):
    monkeypatch.setattr(treport, "hardware", lambda name=None: _row(tanalysis))
    monkeypatch.setattr(jreport, "hardware", lambda name=None: _row(janalysis))
    if which == "pr9_quick":
        with open(BENCH) as f:
            docs = [json.load(f)]
    else:
        docs = _ref_tests_docs()
    for doc in docs:
        assert treport.kernel_rows(doc) == jreport.kernel_rows(doc)
        assert treport.build_table(doc, "h100_sxm") == \
            jreport.build_table(doc, "tpu_v5e")
    if which == "pr9_quick":
        assert len(treport.kernel_rows(docs[0])) == 5


def test_report_main_with_the_h100_row(capsys):
    assert treport.main([BENCH, "--hardware", "h100_sxm"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("roofline vs h100_sxm: 3350 GB/s mem, 67000 Gops/s")
    assert "kernel_compact_inspect_q64_2kslab" in out
    with pytest.raises(SystemExit):
        treport.main([BENCH, "--hardware", "tpu_v5e"])


def test_hardware_table():
    assert trl.hardware("h100_sxm") is trl.H100_SXM
    assert (trl.H100_SXM.mem_bw, trl.H100_SXM.vector_ops) == (3.35e12, 67e12)
    assert trl.H100_SXM.ridge_ai == 67e12 / 3.35e12
    cpu = trl.hardware("cpu_stream")
    assert cpu.name == "cpu_stream" and math.isfinite(cpu.mem_bw)
    assert cpu.mem_bw > 0
    assert trl.hardware("cpu_stream") is cpu
    with pytest.raises(KeyError):
        trl.hardware("abacus")
    with pytest.raises(KeyError):
        trl.hardware("tpu_v5e")


def test_hardware_none_is_the_card_and_raises_without_one():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trl.hardware()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trl.hardware("cuda_stream")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trl.measure_cuda_stream(mbytes=1, reps=1)


def test_measure_cpu_stream_is_positive_and_cached():
    a = trl.measure_cpu_stream(mbytes=8, reps=2)
    b = trl.measure_cpu_stream(mbytes=8, reps=2)
    assert a == b and math.isfinite(a) and a > 0
    assert trl.measure_cpu_stream.cache_info().hits >= 1


def test_all_kernels_are_memory_bound_on_the_h100_row():
    for name, shapes in SHAPES.items():
        for shape in shapes:
            cost = trl.KERNELS[name](**shape)
            assert trl.roofline(cost, 1e-3, trl.H100_SXM)["bound"] == \
                "memory", (name, shape)
