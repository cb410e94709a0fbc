"""The port's configs and models against the JAX package's, on the CPU.

Configs equal field by field. Layers, MoE routing, the Griffin and RWKV
blocks and every architecture's forward take the same numpy inputs and
weights (``convert.model_from_reference`` carries a reference parameter tree
across) and agree within atol = rtol = 2e-4 in float32 at the reference's
reduced sizes; MoE slots are equal exactly. One bfloat16 case pins the dtype
flow with its own tolerance. The port's own init matches the reference's
shapes, dtypes and constant leaves.
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.configs.hippo_default import HippoPaperConfig as JHippoPaper
from repro.models import layers as jl
from repro.models import moe as jmoe
from repro.models import rglru as jrg
from repro.models import rwkv as jrw
from repro.models import transformer as jt
import repro_torch.configs as tcfg
from repro_torch import convert
from repro_torch.configs.hippo_default import HippoPaperConfig as THippoPaper
from repro_torch.models import layers as tl
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trg
from repro_torch.models import rwkv as trw
from repro_torch.models import transformer as tt

ARCHS = ["llama4-maverick-400b-a17b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
         "musicgen-large", "recurrentgemma-9b", "yi-6b", "stablelm-3b",
         "qwen2.5-3b", "smollm-360m", "rwkv6-3b"]
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _light_worker():
    """The shapes here are tiny: one torch intra-op thread does the work as
    fast and leaves the other cores to the tests that run beside these. At
    the end JAX's compile caches go, so that the worker's next file starts
    from a small heap (a full collection there pauses for less)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()
    gc.collect()


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_tree(tree):
    return jax.tree_util.tree_map(lambda a: _t(np.asarray(a)), tree)


def _cfgs(arch, **kw):
    return (jcfg.get_config(arch).reduced(**kw),
            tcfg.get_config(arch).reduced(**kw))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_lists_the_same_architectures():
    assert tcfg.list_archs() == jcfg.list_archs()
    assert set(ARCHS) == set(tcfg.list_archs())


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_by_field(arch):
    for j, t in ((jcfg.get_config(arch), tcfg.get_config(arch)),
                 _cfgs(arch), _cfgs(arch, num_layers=5, dtype="bfloat16")):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        for prop in ("resolved_head_dim", "unit_len", "num_units",
                     "leftover_pattern", "is_attention_free",
                     "supports_long_context"):
            assert getattr(t, prop) == getattr(j, prop), prop
        assert ([dataclasses.asdict(s) for s in tcfg.shape_cells(t)]
                == [dataclasses.asdict(s) for s in jcfg.shape_cells(j)])


def test_shapes_and_paper_config_equal_reference():
    assert ({k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()})
    assert dataclasses.asdict(THippoPaper()) == dataclasses.asdict(JHippoPaper())
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    _close(tl.rms_norm(_t(x), _t(scale)), jl.rms_norm(jnp.asarray(x), scale))
    _close(tl.layer_norm(_t(x), _t(scale), _t(bias)),
           jl.layer_norm(jnp.asarray(x), scale, bias))
    for arch in ("smollm-360m", "stablelm-3b"):         # rmsnorm, layernorm
        jc, tc = _cfgs(arch)
        p = {"scale": scale, "bias": bias}
        _close(tl.apply_norm(tc, _port_tree(p), _t(x)),
               jl.apply_norm(jc, p, jnp.asarray(x)))


@pytest.mark.parametrize("arch,ndim", [("smollm-360m", 2), ("smollm-360m", 3),
                                       ("stablelm-3b", 2),
                                       ("qwen2-vl-7b", 2), ("qwen2-vl-7b", 3),
                                       ("musicgen-large", 2)])
def test_positional_encodings_equal_reference(arch, ndim):
    """RoPE (3-D positions take stream 0), partial rotary (stablelm),
    M-RoPE (text-only positions broadcast to three streams), sinusoidal."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(1)
    b, s = 2, 9
    pos = rng.integers(0, 300, (b, 3, s) if ndim == 3 else (b, s)).astype(np.int32)
    ja = jl.positional_angles(jc, jnp.asarray(pos))
    ta = tl.positional_angles(tc, _t(pos))
    if ja is None:
        assert ta is None
        p2 = pos if ndim == 2 else pos[:, 0]
        _close(tl.sinusoidal_embedding(_t(p2), 64),
               jl.sinusoidal_embedding(jnp.asarray(p2), 64))
        return
    _close(ta[0], ja[0])
    _close(ta[1], ja[1])
    x = rng.standard_normal((b, s, 4, 16)).astype(np.float32)
    _close(tl.apply_rope(_t(x), *ta, tc.rope_fraction),
           jl.apply_rope(jnp.asarray(x), *ja, jc.rope_fraction))


@pytest.mark.parametrize("window,q_offset,q_chunk,sq", [
    (0, 0, 4, 12), (5, 0, 3, 12), (0, 7, 16, 5), (4, 9, 2, 5), (0, 0, 5, 7)])
def test_attention_equals_reference(window, q_offset, q_chunk, sq):
    """Blocked GQA attention with and without a window, with ``q_offset``
    placing the queries, and with a chunk that must shrink to divide Sq."""
    rng = np.random.default_rng(window + 10 * q_offset + sq)
    skv = sq + q_offset
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=q_chunk, q_offset=q_offset)
    _close(tl.attention(_t(q), _t(k), _t(v), **kw),
           jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "stablelm-3b"])
def test_attention_block_and_swiglu_equal_reference(arch):
    jc, tc = _cfgs(arch)
    p = _np_tree(jl.attn_params_init(jc, jax.random.PRNGKey(2)))
    p = {k: v + 0.1 if k.startswith("b") else v for k, v in p.items()}
    f = _np_tree(jl.ffn_params_init(jc, jax.random.PRNGKey(3)))
    x = np.random.default_rng(2).standard_normal((2, 10, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10)[None], (2, 10)).astype(np.int32)
    ja = jl.positional_angles(jc, jnp.asarray(pos))
    ta = tl.positional_angles(tc, _t(pos))
    for got, want in zip(tl.qkv_project(tc, _port_tree(p), _t(x)),
                         jl.qkv_project(jc, p, jnp.asarray(x))):
        _close(got, want)
    _close(tl.attn_apply(tc, _port_tree(p), _t(x), ta, window=4),
           jl.attn_apply(jc, p, jnp.asarray(x), ja, window=4))
    _close(tl.ffn_apply(_port_tree(f), _t(x)), jl.ffn_apply(f, jnp.asarray(x)))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,capacity", [("qwen2-moe-a2.7b", 1.25),
                                           ("qwen2-moe-a2.7b", 0.5),
                                           ("llama4-maverick-400b-a17b", 1.25),
                                           ("llama4-maverick-400b-a17b", 8.0)])
def test_moe_route_apply_and_aux_loss_equal_reference(arch, capacity):
    """Softmax top-4 (renormalized) and sigmoid top-1 routing; at the lower
    capacities assignments are dropped. Slots are equal exactly."""
    jc, tc = _cfgs(arch, capacity_factor=capacity)
    p = _np_tree(jmoe.moe_params_init(jc, jax.random.PRNGKey(4)))
    x = np.random.default_rng(3).standard_normal((3, 16, 64)).astype(np.float32)
    for g in range(x.shape[0]):
        js, jg = jmoe._route(jc, jnp.asarray(x[g]), p["router"])
        ts, tg = tmoe._route(tc, _t(x[g]), _t(p["router"]))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        _close(tg, jg)
    if capacity < 1:
        assert int((np.asarray(js) == jc.num_experts * tmoe.group_capacity(
            tc, 16)).sum()) > 0                  # some assignments dropped
    _close(tmoe.moe_apply(tc, _port_tree(p), _t(x)),
           jmoe.moe_apply(jc, p, jnp.asarray(x)))
    _close(tmoe.aux_load_balance_loss(tc, _t(x), _port_tree(p)),
           jmoe.aux_load_balance_loss(jc, jnp.asarray(x), p))
    assert tmoe.group_capacity(tc, 16) == jmoe.group_capacity(jc, 16)


# ---------------------------------------------------------------------------
# recurrent blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,with_state", [(7, False), (7, True), (300, False),
                                          (1, True)])
def test_griffin_block_equals_reference(s, with_state):
    """The RG-LRU block from a zero and a carried state; S=300 crosses the
    256-step time chunk (chunks of 150), S=1 is a decode step."""
    jc, tc = _cfgs("recurrentgemma-9b")
    p = _np_tree(jrg.rglru_params_init(jc, jax.random.PRNGKey(5)))
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    state = ({"conv": rng.standard_normal((2, 3, 64)).astype(np.float32),
              "h": rng.standard_normal((2, 64)).astype(np.float32)}
             if with_state else None)
    jy, jst = jrg.rglru_block_apply(jc, p, jnp.asarray(x), state)
    ty, tst = trg.rglru_block_apply(tc, _port_tree(p), _t(x),
                                    _port_tree(state) if state else None)
    _close(ty, jy)
    _close(tst["conv"], jst["conv"])
    _close(tst["h"], jst["h"])


@pytest.mark.parametrize("s,with_state", [(6, False), (6, True),
                                          (200, False), (1, True)])
def test_rwkv_block_equals_reference(s, with_state):
    """RWKV6 time-mix and channel-mix from a zero and a carried state; S=200
    crosses the 128-step time chunk (chunks of 100)."""
    jc, tc = _cfgs("rwkv6-3b")
    p = _np_tree(jrw.rwkv_params_init(jc, jax.random.PRNGKey(6)))
    p["bonus"] = np.linspace(-0.5, 0.5, 64).astype(np.float32)
    rng = np.random.default_rng(s + 1)
    x = rng.standard_normal((2, s, 64)).astype(np.float32)
    st = ({"shift": rng.standard_normal((2, 64)).astype(np.float32),
           "wkv": rng.standard_normal((2, 4, 16, 16)).astype(np.float32)}
          if with_state else None)
    jo, jst = jrw.time_mix_apply(jc, p, jnp.asarray(x), st)
    to, tst = trw.time_mix_apply(tc, _port_tree(p), _t(x),
                                 _port_tree(st) if st else None)
    _close(to, jo)
    _close(tst["wkv"], jst["wkv"])
    _close(tst["shift"], jst["shift"])
    cst = {"shift": st["shift"]} if st else None
    jo, jst = jrw.channel_mix_apply(jc, p, jnp.asarray(x), cst)
    to, tst = trw.channel_mix_apply(tc, _port_tree(p), _t(x),
                                    _port_tree(cst) if cst else None)
    _close(to, jo)
    _close(tst["shift"], jst["shift"])


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

def _inputs(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        inputs = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    else:
        inputs = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    return inputs, pos


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(arch):
    jc, tc = _cfgs(arch)
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    inputs, pos = _inputs(jc, 2, 20)
    want = jt.forward(jc, params, jnp.asarray(inputs), jnp.asarray(pos),
                      remat=False)
    model = convert.model_from_reference(tc, _np_tree(params), device="cpu")
    got = tt.forward(model, _t(inputs), _t(pos))
    assert got.shape == (2, 20, tc.vocab_size) and got.dtype == torch.float32
    _close(got, want)


def test_forward_with_leftover_layers_equals_reference():
    """recurrentgemma at 8 layers: 2 units of (rec, rec, attn_local) and two
    leftover rec blocks, carried over from the reference's ``extra``."""
    jc, tc = _cfgs("recurrentgemma-9b", num_layers=8)
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    inputs, pos = _inputs(jc, 2, 20)
    model = convert.model_from_reference(tc, _np_tree(params), device="cpu")
    assert model.kinds == ["rec", "rec", "attn_local"] * 2 + ["rec", "rec"]
    _close(tt.forward(model, _t(inputs), _t(pos)),
           jt.forward(jc, params, jnp.asarray(inputs), jnp.asarray(pos),
                      remat=False))


def test_bfloat16_forward_pins_the_dtype_flow():
    """smollm reduced in bfloat16: both packages round every product to
    bfloat16 (float32 scores and softmax, probabilities cast back before PV),
    so the logits (|x| < 8) differ by about one bfloat16 ulp at 4 (2^-5):
    max 0.05, mean 0.01."""
    jc, tc = _cfgs("smollm-360m", dtype="bfloat16")
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    inputs, pos = _inputs(jc, 2, 32)
    want = np.asarray(jt.forward(jc, params, jnp.asarray(inputs),
                                 jnp.asarray(pos), remat=False), np.float32)
    model = convert.model_from_reference(tc, _np_tree(params), device="cpu")
    got = tt.forward(model, _t(inputs), _t(pos))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 0.05
    assert np.abs(got - want).mean() <= 0.01


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_matches_reference_shapes_dtypes_and_constants(arch):
    """The port's own init (a seeded generator) against the reference's:
    every leaf's shape and dtype, the constant leaves' values, and the
    random ones' spread."""
    jc, tc = _cfgs(arch, dtype="bfloat16")
    ref = _np_tree(jt.init_params(jc, jax.random.PRNGKey(0)))
    model = tt.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    got = dict(model.named_parameters())
    seen = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
        names = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if names[0] == "units":
            j = int(names[1][1:names[1].index("_")])
            for u in range(jc.num_units):
                name = ".".join(["blocks", str(u * jc.unit_len + j),
                                 *names[2:]])
                _check_leaf(names[-1], got[name], leaf[u])
                seen += 1
        elif names[0] == "extra":
            i = jc.num_units * jc.unit_len + names[1]
            _check_leaf(names[-1], got[".".join(["blocks", str(i),
                                                 *names[2:]])], leaf)
            seen += 1
        else:
            _check_leaf(names[-1], got[".".join(names)], leaf)
            seen += 1
    assert seen == len(got)


CONSTANTS = {"decay_base": -6.0, "mu_base": 0.5, "cm_mu": 0.5, "bonus": 0.0,
             "bq": 0.0, "bk": 0.0, "bv": 0.0}


def _check_leaf(name, t, ref):
    want_dtype = "bfloat16" if ref.dtype.name == "bfloat16" else str(ref.dtype)
    assert str(t.dtype).replace("torch.", "") == want_dtype, name
    assert tuple(t.shape) == ref.shape, name
    t = t.float().numpy()
    ref = np.asarray(ref, np.float32)
    if name in ("scale", "bias") or name in CONSTANTS:
        np.testing.assert_array_equal(t, ref, err_msg=name)
    elif name == "lam":
        np.testing.assert_allclose(t, ref, atol=1e-6, err_msg=name)
    elif t.size >= 256:
        # the same distribution: the spread of N(0, 1) * scale
        assert abs(t.std() / ref.std() - 1) < 0.15, name
        assert abs(t.mean()) < 4 * ref.std() / np.sqrt(t.size) + 1e-3, name


def test_init_on_meta_allocates_nothing_and_leftovers_share_one_draw():
    tc = tcfg.get_config("recurrentgemma-9b")
    model = tt.init_params(tc, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert all(p.device.type == "meta" for p in model.parameters())
    assert n > 8e9                      # the published widths, not allocated
    tc8 = tcfg.get_config("recurrentgemma-9b").reduced(num_layers=8)
    m8 = tt.init_params(tc8, torch.Generator().manual_seed(3), "cpu")
    a, b = m8.blocks[6], m8.blocks[7]   # the two leftover rec blocks
    for (na, pa), (nb, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert na == nb and torch.equal(pa, pb)
