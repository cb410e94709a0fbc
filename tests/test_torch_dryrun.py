"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

One subprocess runs the reference (importing ``repro.launch.dryrun`` forces
512 XLA host devices):
  * compiled cells: the reference's own ``lower_cell`` with the production
    mesh patched to (2, 4) and (2, 2, 2) meshes of its host devices and the
    configs to a reduced width, on cells that cover every step kind, both
    meshes and the dense, MoE, hybrid, RWKV and non-token families;
  * all 64 full-size cells, priced without a compile: ``jax.jit`` in the
    module is replaced by one that sums ``NamedSharding.shard_shape`` bytes
    over the step's arguments and stops before lowering.
The port prices the same cells under the same patches (its meshes over meta
devices). Per-device argument bytes are equal exactly, and so are the
accumulation, layout and optimizer dtypes.
"""
import importlib
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import get_config, list_archs, shape_cells
from repro_torch.launch import dryrun
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh_compat
from repro_torch.models import partition as tpartition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")
HBM = 80 * 10**9
REDUCED = dict(d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
               vocab_size=512, d_ff=256, num_layers=5)
# (arch, shape, multi_pod): every step kind, both meshes; dense, MoE (the
# qwen2-moe multi-pod accumulation, the 400b bf16 moments), hybrid, RWKV and
# a non-token frontend
COMPILED = [
    ("yi-6b", "train_4k", False),
    ("qwen2-moe-a2.7b", "train_4k", True),
    ("llama4-maverick-400b-a17b", "train_4k", False),
    ("recurrentgemma-9b", "train_4k", True),
    ("recurrentgemma-9b", "prefill_32k", False),
    ("smollm-360m", "prefill_32k", True),
    ("rwkv6-3b", "long_500k", True),
    ("musicgen-large", "decode_32k", True),
]
XLA_POINTER_BYTES = 8     # XLA's output tuple: one buffer pointer a leaf

_REF_PROG = textwrap.dedent("""
    import json
    import types
    import numpy as np
    import jax
    import repro.launch.dryrun as D
    from repro.configs import get_config, list_archs, shape_cells
    from repro.launch.mesh import make_mesh_compat
    from repro.models import partition

    def shard_bytes(args, shardings):
        return sum(int(np.prod(s.shard_shape(a.shape)))
                   * np.dtype(a.dtype).itemsize
                   for a, s in zip(jax.tree_util.tree_leaves(args),
                                   jax.tree_util.tree_leaves(shardings)))

    class Priced(Exception):
        pass

    seen = {}
    real_jit = jax.jit
    real_train_step = D.steps_lib.make_train_step

    def pricing_jit(fn, in_shardings, **kw):
        class Lowerable:
            def lower(self, *args):
                seen["arg"] = shard_bytes(args, in_shardings)
                if len(args) == 3 and hasattr(args[1], "mu"):
                    seen["moment_dtype"] = str(
                        jax.tree_util.tree_leaves(args[1].mu)[0].dtype)
                raise Priced
        return Lowerable()

    def train_step_spy(cfg, *, accum, accum_dtype):
        seen["accum"], seen["accum_dtype"] = accum, accum_dtype
        return real_train_step(cfg, accum=accum, accum_dtype=accum_dtype)

    out = {"full": {}, "compiled": {}}
    D.jax = types.SimpleNamespace(jit=pricing_jit)
    D.steps_lib.make_train_step = train_step_spy
    for arch in list_archs():
        for shape in shape_cells(get_config(arch)):
            for multi in (False, True):
                seen.clear()
                try:
                    D.lower_cell(arch, shape.name, multi)
                except Priced:
                    pass
                seen["layout"] = ("fsdp_only" if partition.BATCH_AXES_OVERRIDE
                                  else "tp")
                out["full"][f"{arch}/{shape.name}/{multi}"] = dict(seen)
    D.jax = jax
    D.steps_lib.make_train_step = real_train_step

    def keeping_jit(fn, **kw):
        jitted = real_jit(fn, **kw)
        class Lowerable:
            def lower(self, *args):
                low = jitted.lower(*args)
                class Compilable:
                    def compile(self):
                        c = low.compile()
                        seen["out_leaves"] = len(
                            jax.tree_util.tree_leaves(c.output_shardings))
                        return c
                return Compilable()
        return Lowerable()

    D.jax = types.SimpleNamespace(jit=keeping_jit)
    D.make_production_mesh = lambda *, multi_pod=False: (
        make_mesh_compat((2, 2, 2), ("pod", "data", "model")) if multi_pod
        else make_mesh_compat((2, 4), ("data", "model")))
    D.get_config = lambda arch: get_config(arch).reduced(**REDUCED_SRC)
    for arch, shape, multi in COMPILED_SRC:
        seen.clear()
        rec = D.lower_cell(arch, shape, multi)
        rec["out_leaves"] = seen["out_leaves"]
        out["compiled"][f"{arch}/{shape}/{multi}"] = rec
    print(json.dumps(out))
""").replace("REDUCED_SRC", repr(REDUCED)).replace(
    "COMPILED_SRC", repr(COMPILED))


@pytest.fixture(scope="module")
def ref():
    res = subprocess.run(
        [sys.executable, "-c", _REF_PROG], capture_output=True, text=True,
        timeout=600, cwd=REPO,
        env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin",
             "HOME": os.environ.get("HOME", REPO),
             "JAX_PLATFORMS": os.environ.get("JAX_PLATFORMS", "cpu")})
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture
def reduced_small_meshes(monkeypatch):
    """The port's dry run under the reference test's patches: (2, 4) and
    (2, 2, 2) meshes of meta devices and reduced configs."""
    def mesh(*, multi_pod=False, devices=None):
        if multi_pod:
            return make_mesh_compat((2, 2, 2), ("pod", "data", "model"),
                                    [META] * 8)
        return make_mesh_compat((2, 4), ("data", "model"), [META] * 8)

    monkeypatch.setattr(dryrun, "make_production_mesh", mesh)
    monkeypatch.setattr(dryrun, "get_config",
                        lambda arch: get_config(arch).reduced(**REDUCED))


def _keys(rec: dict, prefix: str = "") -> set:
    out = set()
    for k, v in rec.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, prefix + k + ".")
    return out


def _full_cells():
    return [(a, s.name, m) for a in list_archs()
            for s in shape_cells(get_config(a)) for m in (False, True)]


# ---------------------------------------------------------------------------
# (a) compiled reduced cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,multi", COMPILED)
def test_compiled_cell_argument_bytes_equal_xla(ref, reduced_small_meshes,
                                                arch, shape, multi):
    want = ref["compiled"][f"{arch}/{shape}/{multi}"]
    got = dryrun.lower_cell(arch, shape, multi, hbm_bytes=HBM)
    assert got["memory"]["argument_bytes_per_device"] == \
        want["memory"]["argument_bytes_per_device"]
    for key in ("arch", "shape", "kind", "mesh", "devices", "grad_accum",
                "layout"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("arch,shape,multi", COMPILED)
def test_compiled_cell_output_bytes_differ_from_xla_by_its_pointer_table(
        ref, reduced_small_meshes, arch, shape, multi):
    """XLA's ``output_size_in_bytes`` is the outputs' shard bytes plus 8 B a
    leaf of the output tuple; the port counts the shard bytes (312 B fewer
    than XLA on the reduced yi-6b train cell, 39 leaves)."""
    want = ref["compiled"][f"{arch}/{shape}/{multi}"]
    got = dryrun.lower_cell(arch, shape, multi, hbm_bytes=HBM)
    gap = (want["memory"]["output_bytes_per_device"]
           - got["memory"]["output_bytes_per_device"])
    assert gap == XLA_POINTER_BYTES * want["out_leaves"]
    if (arch, shape) == ("yi-6b", "train_4k"):
        assert gap == 312


def test_record_has_every_key_of_the_reference_record(ref,
                                                      reduced_small_meshes):
    """Every key of the reference's record is in the port's, in the same
    nesting; those with no counterpart hold null (and what the reference
    nests under them is absent); the card's two keys are added."""
    for cell, want in ref["compiled"].items():
        arch, shape, multi = cell.split("/")
        got = dryrun.lower_cell(arch, shape, multi == "True", hbm_bytes=HBM)
        want = {k: v for k, v in want.items() if k != "out_leaves"}
        null = set(got["no_counterpart"])
        assert null <= _keys(want)
        for dotted in _keys(want):
            if any(dotted.startswith(n + ".") for n in null):
                continue
            head, _, tail = dotted.partition(".")
            value = got[head][tail] if tail else got[head]
            assert (value is None) == (dotted in null), dotted
        assert _keys(got) - _keys(want) == {"hbm_bytes", "arguments_fit_hbm",
                                            "no_counterpart"}


# ---------------------------------------------------------------------------
# (b) all 64 full-size cells
# ---------------------------------------------------------------------------

def test_full_size_cells_are_the_reference_grid(ref):
    assert len(_full_cells()) == 64
    assert {f"{a}/{s}/{m}" for a, s, m in _full_cells()} == set(ref["full"])


@pytest.mark.parametrize("arch", sorted({a for a, _, _ in _full_cells()}))
def test_full_size_argument_bytes_equal_reference_shard_sums(ref, arch):
    params = tsteps.params_shape(get_config(arch))
    for a, shape, multi in _full_cells():
        if a != arch:
            continue
        want = ref["full"][f"{arch}/{shape}/{multi}"]
        got = dryrun.lower_cell(arch, shape, multi, hbm_bytes=HBM,
                                params=params)
        cell = (arch, shape, multi)
        assert got["memory"]["argument_bytes_per_device"] == want["arg"], cell
        assert got["layout"] == want["layout"], cell
        if got["kind"] == "train":
            plan = dryrun.cell_plan(get_config(arch), next(
                s for s in shape_cells(get_config(arch)) if s.name == shape),
                multi)
            assert got["grad_accum"] == plan.accum == want["accum"], cell
            assert plan.accum_dtype == want["accum_dtype"], cell
            assert plan.moment_dtype == want["moment_dtype"], cell


def test_largest_cell_is_llama4_train_at_8_80_gib():
    got = dryrun.lower_cell("llama4-maverick-400b-a17b", "train_4k", False,
                            hbm_bytes=HBM)
    assert round(got["memory"]["argument_bytes_per_device"] / 2**30, 2) == \
        8.80
    assert got["arguments_fit_hbm"] is True
    small = dryrun.lower_cell("llama4-maverick-400b-a17b", "train_4k", False,
                              hbm_bytes=8 * 2**30)
    assert small["arguments_fit_hbm"] is False


# ---------------------------------------------------------------------------
# (c) module behaviour
# ---------------------------------------------------------------------------

def test_lower_cell_restores_batch_axes_override():
    before = tpartition.BATCH_AXES_OVERRIDE
    try:
        for sentinel in (None, ("data",)):
            tpartition.BATCH_AXES_OVERRIDE = sentinel
            rec = dryrun.lower_cell("yi-6b", "train_4k", False, hbm_bytes=HBM)
            assert rec["layout"] == "fsdp_only"
            assert tpartition.BATCH_AXES_OVERRIDE == sentinel
    finally:
        tpartition.BATCH_AXES_OVERRIDE = before


def test_import_sets_no_environment_variable():
    before = dict(os.environ)
    importlib.reload(dryrun)
    assert dict(os.environ) == before


def test_lower_cell_needs_the_card_for_its_memory():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.lower_cell("smollm-360m", "train_4k", False)


def test_cell_blocks_sum_to_the_record():
    cfg = get_config("smollm-360m")
    shape = next(s for s in shape_cells(cfg) if s.name == "decode_32k")
    plan, args, outs = dryrun.cell_blocks(cfg, shape, True)
    rec = dryrun.lower_cell("smollm-360m", "decode_32k", True, hbm_bytes=HBM)
    assert plan.accum == rec["grad_accum"] == 1
    assert dryrun.blocks_bytes(args) == \
        rec["memory"]["argument_bytes_per_device"]
    assert dryrun.blocks_bytes(outs) == \
        rec["memory"]["output_bytes_per_device"]
    # decode: the parameters, 32 layers' K and V, the tokens and pos
    assert len(args) == len(list(tsteps.params_shape(cfg).parameters())) \
        + 2 * cfg.num_layers + 2
    assert args[-1] == ((), torch.int32)


def test_main_writes_a_record_a_cell(tmp_path, capsys):
    dryrun.main(["--arch", "smollm-360m", "--mesh", "single", "--out",
                 str(tmp_path), "--hbm-bytes", str(HBM)])
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == [f"smollm-360m_{s}_single.json"
                     for s in ("decode_32k", "prefill_32k", "train_4k")]
    rec = json.loads((tmp_path / files[-1]).read_text())
    assert rec == dryrun.lower_cell("smollm-360m", "train_4k", False,
                                    hbm_bytes=HBM)
    out = capsys.readouterr().out
    assert out.count("OK   ") == 3 and "all cells priced" in out


def test_main_exits_nonzero_when_a_cell_fails(tmp_path, monkeypatch, capsys):
    real = dryrun.lower_cell

    def failing(arch, shape, multi, **kw):
        if shape == "prefill_32k":
            raise ValueError("boom")
        return real(arch, shape, multi, **kw)

    monkeypatch.setattr(dryrun, "lower_cell", failing)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "yi-6b", "--mesh", "both", "--out",
                     str(tmp_path), "--hbm-bytes", str(HBM)])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert out.count("OK   ") == 4 and out.count("FAIL ") == 2
