"""The port's optimizer (``repro_torch.optim``) against the JAX package's,
on the CPU.

The same numpy inputs go through both. Tolerances: ``q8_encode`` /
``q8_decode`` bit-exact; ``warmup_cosine`` and ``clip_by_global_norm``
within 1e-6 relative; ``adamw_update``, fed the reference's own gradients,
within atol = rtol = 1e-6 for parameters and moments over three steps, for
float32, bfloat16 and int8 moments. The global norm's squares are summed in
another order than the reference's (per layer, not per stacked unit leaf),
so the clip scale may differ by an ulp; where a one-ulp change of the scale
could flip a bfloat16 or int8 rounding of a moment, the steps run with a
``max_grad_norm`` above the norm (scale exactly 1), and the float32 case
also runs with the default clip.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.models import transformer as jt
from repro.optim import adamw as ja
from repro.optim import schedule as js
import repro_torch.configs as tcfg
from repro_torch import convert
from repro_torch.launch import steps as tsteps
from repro_torch.optim import adamw as ta
from repro_torch.optim import schedule as ts

TOL = dict(rtol=1e-6, atol=1e-6)
# The reference's gradients are compiled with XLA's backend optimizations
# off: half the compile time, the same function.
FAST_COMPILE = {"xla_backend_optimization_level": "0",
                "xla_llvm_disable_expensive_passes": True}


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


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


@pytest.mark.parametrize("shape,scale", [((5, 33), 1.0), ((2, 3, 64), 1e-3),
                                         ((7, 1), 10.0), ((4, 16), 0.0),
                                         ((3, 8), 1e-30)])
def test_q8_encode_decode_bit_exact(shape, scale):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    want = ja.q8_encode(jnp.asarray(x))
    got = ta.q8_encode(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))
    np.testing.assert_array_equal(ta.q8_decode(got).numpy(),
                                  np.asarray(ja.q8_decode(want)))


@pytest.mark.parametrize("warmup,total", [(2, 50), (100, 1000), (0, 10),
                                          (5, 5)])
def test_warmup_cosine_equals_reference(warmup, total):
    for step in list(range(0, total + 3)) + [total * 2]:
        want = float(js.warmup_cosine(step, peak_lr=3e-4, warmup_steps=warmup,
                                      total_steps=total))
        got = ts.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                               peak_lr=3e-4, warmup_steps=warmup,
                               total_steps=total)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 1e3, 0.01])
def test_clip_by_global_norm_equals_reference(max_norm):
    rng = np.random.default_rng(4)
    grads = {f"g{i}": rng.standard_normal(s).astype(np.float32) * 0.3
             for i, s in enumerate([(8, 5), (3,), (2, 4, 6), (1,)])}
    want, wn = ja.clip_by_global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()}, max_norm)
    got, gn = ta.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in grads.items()}, max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6, atol=0)
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
    bf = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in grads.items()}
    clipped, _ = ta.clip_by_global_norm(bf, max_norm)
    assert all(clipped[k].dtype == torch.bfloat16 for k in bf)


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {"inputs": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "positions": np.broadcast_to(np.arange(s)[None], (b, s)).astype(
                np.int32).copy()}


def _to_port_named(cfg, tree) -> dict:
    """A reference tree (of the parameters' form) as {name: tensor}."""
    tt = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    return {n: convert._reference_leaf(cfg, tt, n)
            for n in convert._param_names(cfg)}


@pytest.fixture(scope="module")
def smollm():
    """Reduced smollm's configs, the reference's initial parameters, its
    gradient function (compiled once for the module) and its update, run
    op by op: compiled whole, XLA contracts ``b1 * m + (1 - b1) * g`` into
    fused multiply-adds, which moves a moment by an ulp before its bfloat16
    rounding."""
    jc = jcfg.get_config("smollm-360m").reduced()
    tc = tcfg.get_config("smollm-360m").reduced()
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(jc, p, b, remat=False)),
        compiler_options=FAST_COMPILE)
    return (jc, tc, jt.init_params(jc, jax.random.PRNGKey(0)), grad_fn,
            ja.adamw_update)


@pytest.mark.parametrize("moment_dtype,max_norm", [
    ("float32", 1.0), ("float32", 1e9), ("bfloat16", 1e9), ("int8", 1e9)])
def test_adamw_update_given_reference_gradients_equals_reference(
        smollm, moment_dtype, max_norm):
    """Three steps of reduced smollm (float32 parameters): each step's
    gradients are the reference's at its own parameters; the port's
    parameters, moments and step equal the reference's within 1e-6."""
    jc, tc, params, grad_fn, update = smollm
    model = convert.model_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    jstate = ja.adamw_init(params, moment_dtype)
    tstate = ta.adamw_init(model, moment_dtype)
    for it in range(3):
        batch = {k: jnp.asarray(v) for k, v in _batch(jc, 2, 16, it).items()}
        _, g = grad_fn(params, batch)
        lr = 1e-3 * (it + 1)
        params, jstate, jm = update(g, jstate, params, lr=jnp.float32(lr),
                                    max_grad_norm=max_norm)
        model, tstate, tm = ta.adamw_update(
            _to_port_named(tc, g), tstate, model,
            lr=torch.tensor(lr, dtype=torch.float32), max_grad_norm=max_norm)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        assert int(tstate.step) == int(jstate.step) == it + 1
        got = jax.tree_util.tree_leaves(convert.params_to_reference(tc, model))
        for a, b in zip(got, jax.tree_util.tree_leaves(params), strict=True):
            np.testing.assert_allclose(_f32(a), _f32(b), **TOL)
        ref_state = convert.opt_state_to_reference(tc, tstate)
        for a, b in zip(jax.tree_util.tree_leaves((ref_state.mu, ref_state.nu)),
                        jax.tree_util.tree_leaves((jstate.mu, jstate.nu)),
                        strict=True):
            assert str(a.dtype).replace("torch.", "") == str(b.dtype)
            np.testing.assert_allclose(_f32(a), _f32(b), **TOL)


def test_update_writes_the_modules_parameters_in_place():
    tc = tcfg.get_config("smollm-360m").reduced()
    model = tsteps.transformer.init_params(
        tc, torch.Generator().manual_seed(0), "cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ptrs = {n: p.data_ptr() for n, p in model.named_parameters()}
    state = ta.adamw_init(model)
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    out, state, _ = ta.adamw_update(grads, state, model, lr=1e-2)
    assert out is model
    for n, p in model.named_parameters():
        assert p.data_ptr() == ptrs[n]
        assert not torch.equal(p, before[n]), n


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_opt_state_shape_equals_reference(moment_dtype):
    """``opt_state_shape`` on the meta device: every moment's shape and
    dtype equals the reference's (restacked), and nothing is allocated."""
    arch = "qwen2-moe-a2.7b"
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    want = jax.eval_shape(lambda p: ja.adamw_init(p, moment_dtype),
                          jax.eval_shape(lambda k: jt.init_params(jc, k),
                                         jax.random.PRNGKey(0)))
    got = tsteps.opt_state_shape(tc, tsteps.params_shape(tc), moment_dtype)
    assert got.step.device.type == "meta" and got.step.dtype == torch.int32
    ref = convert.opt_state_to_reference(tc, got)
    leaves = jax.tree_util.tree_leaves((ref.mu, ref.nu))
    wleaves = jax.tree_util.tree_leaves((want.mu, want.nu))
    assert len(leaves) == len(wleaves)
    for a, b in zip(leaves, wleaves):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
