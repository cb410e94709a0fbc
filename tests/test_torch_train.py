"""The port's training path (``transformer.loss_fn``, ``steps.make_train_step``
and the train CLI) against the JAX package's, on the CPU.

The same numpy weights (``convert.model_from_reference``) and batches go
through both. Tolerances: the loss and every gradient leaf of all ten
reduced architectures within 2e-4 relative to the leaf's largest magnitude
(the models' tolerance); three train steps of four block families at
``accum`` 1 and 2: loss and grad norm per step within 2e-4 relative, the
parameters within atol = rtol = 2e-4 on at least 99.9% of entries and no
entry off by more than 2 * lr per step (Adam's first steps move an entry by
about lr * sign(g), so a gradient near zero may flip its sign). The train
CLI stopped with ``--stop-after`` and resumed gives the uninterrupted run's
losses bit for bit.
"""
import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.launch import steps as jsteps
from repro.models import transformer as jt
from repro.optim import adamw_init as jadamw_init
import repro_torch.configs as tcfg
from repro_torch import convert
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tt
from repro_torch.optim import adamw_init as tadamw_init

ARCHS = ["llama4-maverick-400b-a17b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
         "musicgen-large", "recurrentgemma-9b", "yi-6b", "stablelm-3b",
         "qwen2.5-3b", "smollm-360m", "rwkv6-3b"]
STEP_ARCHS = ["smollm-360m", "qwen2-moe-a2.7b", "recurrentgemma-9b",
              "rwkv6-3b"]
TOL = 2e-4
LR = 1e-3
# The reference's functions are compiled with XLA's backend optimizations
# off: half the compile time, the same functions.
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


def _cfgs(arch, **kw):
    return (jcfg.get_config(arch).reduced(**kw),
            tcfg.get_config(arch).reduced(**kw))


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str):
    """The reference's reduced parameters (drawn once per module: the draw
    is most of a case's time)."""
    return jt.init_params(jcfg.get_config(arch).reduced(),
                          jax.random.PRNGKey(0))


def _batch(cfg, b, s, seed, masked: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    else:
        inputs = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, :masked] = -1
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32).copy()
    return {"inputs": inputs, "labels": labels, "positions": pos}


def _port_model(tc, params):
    return convert.model_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _port_grads(model, batch, **kw):
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss = tt.loss_fn(model, {k: torch.from_numpy(v) for k, v in
                              batch.items()}, **kw)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), dict(zip(named, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_reference(arch):
    """Chunked loss (ce_chunk 8 over 20 positions: chunks of 5), three
    masked labels, rematerialized trunk: the loss and every gradient leaf,
    restacked (``convert.tree_to_reference``), equal the reference's."""
    jc, tc = _cfgs(arch)
    params = _ref_params(arch)
    batch = _batch(jc, 2, 20, 1, masked=3)
    want_loss, want = jax.jit(jax.value_and_grad(lambda p: jt.loss_fn(
        jc, p, {k: jnp.asarray(v) for k, v in batch.items()},
        ce_chunk=8)), compiler_options=FAST_COMPILE)(params)
    loss, grads = _port_grads(_port_model(tc, params), batch, ce_chunk=8)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=TOL)
    got = convert.tree_to_reference(tc, grads)
    leaves = jax.tree_util.tree_leaves_with_path(want)
    for (path, w), g in zip(leaves, jax.tree_util.tree_leaves(got),
                            strict=True):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= TOL, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch,layers", [("smollm-360m", None),
                                         ("recurrentgemma-9b", 8)])
def test_remat_and_chunks_keep_the_loss_and_gradients(arch, layers):
    """Rematerialization recomputes the same values: loss and gradients
    with and without ``remat`` are equal exactly (recurrentgemma at 8
    layers has two leftover blocks). The chunked loss equals one unchunked
    cross entropy over the unmasked labels."""
    kw = {"num_layers": layers} if layers else {}
    _, tc = _cfgs(arch, **kw)
    model = tt.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    batch = _batch(tc, 2, 12, 2, masked=5)
    l0, g0 = _port_grads(model, batch, remat=False, ce_chunk=5)   # chunks of 4
    l1, g1 = _port_grads(model, batch, remat=True, ce_chunk=5)
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    with torch.no_grad():
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        logits = tt.forward(model, tb["inputs"], tb["positions"]).float()
        lab = tb["labels"].long()
        full = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), lab.reshape(-1),
            ignore_index=-1)
    torch.testing.assert_close(l0, full, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_steps_equal_reference(arch, accum):
    """Three steps of ``make_train_step`` (lr 1e-3, warmup 2, remat on, float32
    accumulation) from the same weights on the same batches."""
    jc, tc = _cfgs(arch)
    params = _ref_params(arch)
    model = _port_model(tc, params)
    kw = dict(peak_lr=LR, warmup=2, total=10, accum=accum)
    jstep = jax.jit(jsteps.make_train_step(jc, **kw),
                    compiler_options=FAST_COMPILE)
    tstep = tsteps.make_train_step(tc, **kw)
    jstate, tstate = jadamw_init(params), tadamw_init(model)
    for it in range(3):
        batch = _batch(jc, 4, 16, 10 + it)
        params, jstate, jm = jstep(params, jstate,
                                   {k: jnp.asarray(v) for k, v in
                                    batch.items()})
        model, tstate, tm = tstep(model, tstate,
                                  {k: torch.from_numpy(v) for k, v in
                                   batch.items()})
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=TOL, err_msg=f"{key} step {it}")
        got = jax.tree_util.tree_leaves(convert.params_to_reference(tc, model))
        want = [np.asarray(w) for w in jax.tree_util.tree_leaves(params)]
        off = total = 0
        for g, w in zip(got, want, strict=True):
            diff = np.abs(g.numpy() - w)
            off += int((diff > TOL + TOL * np.abs(w)).sum())
            total += w.size
            assert diff.max() <= 2 * LR * (it + 1)
        assert off <= 1e-3 * total, (it, off, total)


def test_train_step_turns_on_gradients_and_updates_in_place():
    _, tc = _cfgs("smollm-360m")
    model = tt.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in model.parameters())
    ptrs = [p.data_ptr() for p in model.parameters()]
    state = tadamw_init(model)
    step = tsteps.make_train_step(tc, peak_lr=LR, warmup=0, total=4)
    batch = {k: torch.from_numpy(v) for k, v in _batch(tc, 2, 8, 3).items()}
    out, state, metrics = step(model, state, batch)
    assert out is model and int(state.step) == 1
    assert all(p.requires_grad for p in model.parameters())
    assert [p.data_ptr() for p in model.parameters()] == ptrs
    assert metrics["loss"].shape == () and metrics["grad_norm"].shape == ()


def test_train_cli_resume_is_bit_identical(tmp_path, capsys):
    """The reference's preemption contract on the port: 6 steps run through;
    then 3 steps with ``--stop-after 3`` and a ``--resume`` of the rest give
    the same six losses bit for bit, and print the reference's lines."""
    common = ["--arch", "smollm-360m", "--reduced", "--device", "cpu",
              "--steps", "6", "--batch", "4", "--seq", "16",
              "--quality-min", "0.5"]
    whole = ttrain.main(common + ["--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert out.startswith("data: ") and "via Hippo index" in out
    assert "step     0  loss " in out and "gnorm" in out
    assert "done: 6 steps" in out and "loss: first " in out
    first = ttrain.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                                  "--stop-after", "3"])
    rest = ttrain.main(common + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(whole) == 6 and first + rest == whole
    assert all(np.isfinite(whole))


def test_train_cli_device_none_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--reduced", "--steps", "1"])
