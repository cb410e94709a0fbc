"""The port's training checkpoints (``repro_torch.checkpointing.checkpoint``)
against the JAX package's, on the CPU.

The same state (the reference's, carried across by ``convert``) saved by
each package gives byte-identical leaf files and manifests equal but for the
``treedef`` fingerprint; each package restores the other's directory to the
same values. The reference's restore of a bfloat16 leaf returns numpy's
``V2`` void words (its fault, recorded in ROADMAP.md); the port reads them
as bfloat16 by the manifest's dtype. Both are pinned here.
"""
import functools
import gc
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.checkpointing.checkpoint import restore_checkpoint as jrestore
from repro.checkpointing.checkpoint import save_checkpoint as jsave
from repro.models import transformer as jt
from repro.optim import adamw as ja
import repro_torch.configs as tcfg
from repro_torch import convert
from repro_torch.checkpointing import (CheckpointManager, latest_step,
                                       restore_checkpoint, save_checkpoint)
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw as ta


@pytest.fixture(autouse=True, scope="module")
def _light_worker():
    """One torch intra-op thread for these tiny shapes; JAX's compile caches
    dropped at the end."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()
    gc.collect()


def _bits(x) -> np.ndarray:
    """An array's bytes as unsigned words (bfloat16 of either package)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 and x.dtype.kind in (
        "V", "f") else x


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, dtype: str, layers):
    """The reference's reduced parameters, drawn once per module."""
    kw = {"num_layers": layers} if layers else {}
    return jt.init_params(jcfg.get_config(arch).reduced(dtype=dtype, **kw),
                          jax.random.PRNGKey(0))


def _reference_state(arch, moment_dtype, dtype="float32", **kw):
    """A reference train state with seeded moments (int8 ones through the
    reference's ``q8_encode``) at step 3, and the same state in the port's
    form."""
    tc = tcfg.get_config(arch).reduced(dtype=dtype, **kw)
    params = _ref_params(arch, dtype, kw.get("num_layers"))
    rng = np.random.default_rng(2)

    def moment(p):
        x = (rng.standard_normal(p.shape) * 1e-3).astype(np.float32)
        if moment_dtype == "int8":
            return ja.q8_encode(jnp.asarray(x))
        return jnp.asarray(x).astype(moment_dtype)

    opt = ja.AdamWState(step=jnp.int32(3),
                        mu=jax.tree_util.tree_map(moment, params),
                        nu=jax.tree_util.tree_map(moment, params))
    state = {"params": params, "opt": opt}
    host = jax.tree_util.tree_map(np.asarray, state)
    port = {"params": convert.model_from_reference(tc, host["params"],
                                                   device="cpu"),
            "opt": convert.opt_state_from_reference(tc, host["opt"],
                                                    device="cpu")}
    return state, port


CASES = [("smollm-360m", "float32", "float32", {}),
         ("smollm-360m", "bfloat16", "float32", {}),
         ("smollm-360m", "int8", "float32", {}),
         ("recurrentgemma-9b", "float32", "float32", {"num_layers": 8}),
         ("smollm-360m", "float32", "bfloat16", {}),
         ("qwen2-moe-a2.7b", "int8", "bfloat16", {})]


@pytest.mark.parametrize("arch,moment_dtype,dtype,kw", CASES)
def test_leaf_files_are_byte_identical_to_reference(tmp_path, arch,
                                                     moment_dtype, dtype, kw):
    state, port = _reference_state(arch, moment_dtype, dtype, **kw)
    jsave(tmp_path / "ref", 7, state)
    save_checkpoint(tmp_path / "port", 7, port)
    jd, td = tmp_path / "ref" / "step_7", tmp_path / "port" / "step_7"
    jm = json.loads((jd / "manifest.json").read_text())
    tm = json.loads((td / "manifest.json").read_text())
    assert tm["treedef"] != jm.pop("treedef") and tm.pop("treedef")
    assert tm == jm
    n = len(jm["leaves"])
    assert sorted(p.name for p in td.iterdir()) == sorted(
        p.name for p in jd.iterdir())
    for i in range(n):
        assert (td / f"leaf_{i}.npy").read_bytes() == (
            jd / f"leaf_{i}.npy").read_bytes(), (i, jm["leaves"][i])
    assert (td / "COMMITTED").exists() and latest_step(tmp_path / "port") == 7


@pytest.mark.parametrize("arch,moment_dtype,dtype,kw", CASES)
def test_each_package_restores_the_others_checkpoint(tmp_path, arch,
                                                     moment_dtype, dtype, kw):
    """The port restores the reference's directory into its own state (the
    template's devices and dtypes), bit for bit; the reference restores the
    port's float32 directory, bit for bit (a bfloat16 leaf comes back as
    ``V2`` words there: the next test)."""
    state, port = _reference_state(arch, moment_dtype, dtype, **kw)
    tc = port["params"].cfg
    jsave(tmp_path / "ref", 3, state)
    step, got = restore_checkpoint(tmp_path / "ref", treedef_like=port)
    assert step == 3
    assert isinstance(got["params"], tt.Transformer)
    assert isinstance(got["opt"], ta.AdamWState)
    for n, p in port["params"].named_parameters():
        q = dict(got["params"].named_parameters())[n]
        assert q.dtype == p.dtype and q.device == p.device
        np.testing.assert_array_equal(_bits(q), _bits(p), n)
    want = jax.tree_util.tree_leaves(convert.opt_state_to_reference(
        tc, port["opt"]))
    have = jax.tree_util.tree_leaves(convert.opt_state_to_reference(
        tc, got["opt"]))
    for a, b in zip(have, want, strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))

    save_checkpoint(tmp_path / "port", 4, port)
    step, back = jrestore(tmp_path / "port", treedef_like=state)
    assert step == 4
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(state), strict=True):
        if np.asarray(b).dtype.name == "bfloat16":
            assert np.asarray(a).dtype.kind == "V"
        else:
            assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_bfloat16_leaf_restore_pins_both_packages(tmp_path):
    """A bfloat16 leaf saved by the reference: its own restore returns a
    ``V2`` void array with the same bytes (it cannot be made a JAX array:
    the reference's fault); the port's returns bfloat16 with those bits."""
    x = jnp.asarray(np.linspace(-3, 3, 12, dtype=np.float32),
                    jnp.bfloat16).reshape(3, 4)
    jsave(tmp_path, 1, {"a": x})
    _, back = jrestore(tmp_path, treedef_like={"a": x})
    assert back["a"].dtype == np.dtype("V2")
    np.testing.assert_array_equal(back["a"].view(np.uint16),
                                  np.asarray(x).view(np.uint16))
    with pytest.raises(TypeError):
        jnp.asarray(back["a"])
    template = {"a": torch.zeros((3, 4), dtype=torch.bfloat16)}
    _, got = restore_checkpoint(tmp_path, treedef_like=template)
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["a"]),
                                  np.asarray(x).view(np.uint16))
    save_checkpoint(tmp_path / "port", 1, {"a": got["a"]})
    assert (tmp_path / "port" / "step_1" / "leaf_0.npy").read_bytes() == (
        tmp_path / "step_1" / "leaf_0.npy").read_bytes()


def test_manager_keeps_the_last_commits_and_writes_behind(tmp_path):
    """``keep=2`` collects older steps; an async save takes its host copies
    before it returns, so training that updates the tensors in place right
    after does not reach the files; an uncommitted directory is ignored."""
    tc = tcfg.get_config("smollm-360m").reduced()
    model = tt.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    state = {"params": model, "opt": ta.adamw_init(model, "int8")}
    mgr = CheckpointManager(tmp_path, keep=2, async_write=True)
    saved = {}
    for step in (1, 2, 3):
        mgr.save(step, state)
        saved[step] = {n: p.detach().clone()
                       for n, p in model.named_parameters()}
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)                     # in place, during the write
    mgr.wait()
    assert sorted(d.name for d in tmp_path.iterdir()) == ["step_2", "step_3"]
    (tmp_path / "step_9").mkdir()               # a crash before COMMITTED
    assert latest_step(tmp_path) == 3
    step, got = mgr.restore_latest(state)
    assert step == 3
    for n, p in got["params"].named_parameters():
        assert torch.equal(p, saved[3][n]), n
    assert got["params"] is not model and int(got["opt"].step) == 0
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(tmp_path, treedef_like={"params": model})
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none", treedef_like=state)
    assert not any(t.name.startswith("Thread") and t.is_alive()
                   and t is not threading.main_thread()
                   for t in threading.enumerate() if t.daemon)


def test_restore_onto_a_mesh_of_one_device(tmp_path):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.shardings import replicated
    tc = tcfg.get_config("smollm-360m").reduced()
    model = tt.init_params(tc, torch.Generator().manual_seed(1), "cpu")
    state = {"params": model, "opt": ta.adamw_init(model)}
    save_checkpoint(tmp_path, 5, state)
    cpu = torch.device("cpu")
    one = replicated(make_host_mesh(2, 1, devices=[cpu, cpu]))
    _, got = restore_checkpoint(tmp_path, treedef_like=state, shardings=one)
    assert got["params"].device == cpu
    two = replicated(make_host_mesh(2, 1, devices=[cpu, torch.device("meta")]))
    with pytest.raises(NotImplementedError, match="distinct devices"):
        restore_checkpoint(tmp_path, treedef_like=state, shardings=two)
