"""The port's serving path against the JAX package's, on the CPU.

The same reference weights (``convert.model_from_reference``) and inputs go
through both packages' ``prefill`` and ``decode_step``: logits agree within
atol = rtol = 2e-4 in float32 at the reference's reduced sizes, and so do the
caches (``convert.cache_to_reference`` restacks the port's). MoE configs use
capacity_factor 8, as ``tests/test_serve_decode.py`` does, so no token is
dropped. The two batch servers give the same tokens on one seeded queue, and
the reference server's two properties (leftover-layer caches that admit does
not merge, lock-step decode at the largest position) hold in both.
"""
import gc
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.launch import serve as jlaunch
from repro.models import serve as js
from repro.models import transformer as jt
import repro_torch.configs as tcfg
from repro_torch import convert
from repro_torch.launch import serve as tlaunch
from repro_torch.models import serve as ts
from repro_torch.models import transformer as tt

ARCHS = ["yi-6b", "stablelm-3b", "qwen2.5-3b", "llama4-maverick-400b-a17b",
         "recurrentgemma-9b", "rwkv6-3b", "musicgen-large", "qwen2-vl-7b"]
B, S = 2, 12
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


def _setup(arch, **kw):
    jc = jcfg.get_config(arch).reduced(**kw)
    tc = tcfg.get_config(arch).reduced(**kw)
    if jc.num_experts:
        jc = replace(jc, capacity_factor=8.0)
        tc = replace(tc, capacity_factor=8.0)
    params = jt.init_params(jc, jax.random.PRNGKey(0))
    model = convert.model_from_reference(
        tc, jax.tree_util.tree_map(np.asarray, params), device="cpu")
    return jc, tc, params, model


def _inputs(cfg, b, s, seed=1):
    rng = np.random.default_rng(seed)
    if cfg.frontend == "tokens":
        return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)


def _close_caches(tc, port_cache, ref_cache):
    want = jax.tree_util.tree_map(np.asarray, ref_cache)
    got = convert.cache_to_reference(tc, port_cache)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_reference(arch):
    jc, tc, params, model = _setup(arch)
    inputs = _inputs(jc, B, S)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    max_seq = S + 4
    jl, jcache = js.prefill(jc, params, jnp.asarray(inputs[:, :S - 3]),
                            jnp.asarray(pos[:, :S - 3]), max_seq)
    tl, tcache = ts.prefill(model, _t(inputs[:, :S - 3]),
                            _t(pos[:, :S - 3]), max_seq)
    _close(tl, jl)
    _close_caches(tc, tcache, jcache)
    for t in range(S - 3, S):
        jl, jcache = js.decode_step(jc, params, jcache,
                                    jnp.asarray(inputs[:, t:t + 1]),
                                    jnp.int32(t))
        tl, tcache = ts.decode_step(model, tcache, _t(inputs[:, t:t + 1]), t)
        _close(tl, jl)
        _close_caches(tc, tcache, jcache)
    # and the port's decode equals its own teacher-forced forward
    full = tt.forward(model, _t(inputs), _t(pos))
    _close(tl, full[:, S - 1])


def test_local_window_rolling_buffer_equals_reference():
    """Prefill past the window (the rolled long-prefill case) and decode past
    it again: the rolling buffer's logits and contents equal the reference's,
    and the logits its own forward's."""
    jc, tc, params, model = _setup("recurrentgemma-9b")
    total = jc.window * 2 + 5
    inputs = _inputs(jc, 1, total)
    pos = np.arange(total)[None, :].astype(np.int32)
    ref = tt.forward(model, _t(inputs), _t(pos))
    decode = jax.jit(lambda p, c, x, t: js.decode_step(jc, p, c, x, t))
    for s0 in (jc.window - 3, jc.window + 2):
        jl, jcache = js.prefill(jc, params, jnp.asarray(inputs[:, :s0]),
                                jnp.asarray(pos[:, :s0]), total)
        tl, tcache = ts.prefill(model, _t(inputs[:, :s0]), _t(pos[:, :s0]),
                                total)
        _close(tl, jl)
        _close_caches(tc, tcache, jcache)
        for t in range(s0, total):
            jl, jcache = decode(params, jcache,
                                jnp.asarray(inputs[:, t:t + 1]), jnp.int32(t))
            tl, tcache = ts.decode_step(model, tcache,
                                        _t(inputs[:, t:t + 1]), t)
            _close(tl, jl, rtol=3e-4, atol=3e-4)
            _close(tl, ref[:, t], rtol=3e-4, atol=3e-4)
        _close_caches(tc, tcache, jcache)


def test_generate_greedy_equals_reference_and_sampling_stays_in_range():
    jc, tc, params, model = _setup("smollm-360m")
    prompt = _inputs(jc, 2, 8)
    want = np.asarray(js.generate(jc, params, jnp.asarray(prompt),
                                  num_steps=6, max_seq=20))
    got = ts.generate(model, _t(prompt), num_steps=6, max_seq=20).numpy()
    # greedy tokens equal wherever the reference's top-2 margin exceeds the
    # tolerance (both packages follow the same prefix until they differ)
    logits = np.asarray(jt.forward(jc, params, jnp.asarray(
        np.concatenate([prompt, want], axis=1)),
        jnp.broadcast_to(jnp.arange(14)[None], (2, 14)), remat=False))
    top2 = np.sort(logits[:, 7:13], axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    for row in range(2):
        for step in range(6):
            if margin[row, step] <= 2e-4:
                break
            assert got[row, step] == want[row, step], (row, step)
    with pytest.raises(ValueError, match="generator"):
        ts.generate(model, _t(prompt), 2, 20, temperature=0.7)
    out = ts.generate(model, _t(prompt), num_steps=6, max_seq=20,
                      temperature=0.7,
                      generator=torch.Generator().manual_seed(1))
    assert out.shape == (2, 6)
    assert bool((out >= 0).all()) and bool((out < tc.vocab_size).all())


def _queue(cfg, n, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, lens[i % len(lens)]).astype(
        np.int32) for i in range(n)]


def _serve(mod, server, prompts, gen):
    queue = [mod.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
    done = []
    while len(done) < len(prompts):
        while queue and server.admit(queue[0]):
            queue.pop(0)
        server.step()
        done.extend(server.retire(gen))
    return {r.rid: r.generated for r in done}


def test_batch_server_equals_reference_on_a_seeded_queue():
    """6 requests at batch 4 (two admitted after the first four retire),
    greedy tokens equal."""
    jc, tc, params, model = _setup("smollm-360m")
    prompts = _queue(jc, 6, [16])
    want = _serve(jlaunch, jlaunch.BatchServer(jc, params, 4, 16 + 24 + 1),
                  prompts, 24)
    got = _serve(tlaunch, tlaunch.BatchServer(model, 4, 16 + 24 + 1),
                 prompts, 24)
    assert got == want
    assert all(len(v) == 24 for v in got.values())


@pytest.mark.parametrize("batch", [2, 3])
def test_leftover_layer_caches_are_not_merged_as_in_reference(batch):
    """recurrentgemma at 8 layers (2 units, 2 leftover rec blocks): after
    ``admit`` the unit layers hold the prompt's state and the leftover
    layers' state stays zero, in both packages (the reference merges only
    leaves whose axis 1 is the batch). At batch 3 the leftover conv tails
    (B, 3, d) have axis 1 equal to the batch, and the wrong axis is
    written: every row's tap 0 gets the prompt's."""
    jc, tc, params, model = _setup("recurrentgemma-9b", num_layers=8)
    prompt = _queue(jc, 1, [10])[0]
    jsrv = jlaunch.BatchServer(jc, params, batch, 24)
    tsrv = tlaunch.BatchServer(model, batch, 24)
    assert jsrv.admit(jlaunch.Request(0, prompt))
    assert tsrv.admit(tlaunch.Request(0, prompt))
    _close_caches(tc, tsrv.cache, jsrv.cache)
    for layer in tsrv.cache[6:]:
        assert not layer["h"].any()
        if batch == 3:
            conv = layer["conv"]
            assert not conv[:, 1:].any() and conv[:, 0].abs().sum() > 0
            assert bool((conv[:, 0] == conv[:1, 0]).all())
        else:
            assert not layer["conv"].any()
    assert tsrv.cache[0]["h"][0].abs().sum() > 0
    for _ in range(3):
        jsrv.step()
        tsrv.step()
    _close_caches(tc, tsrv.cache, jsrv.cache)
    assert tsrv.slots[0].generated == jsrv.slots[0].generated


def test_lock_step_decodes_a_late_slot_at_the_largest_position():
    """A request admitted while another has decoded writes its K/V at the
    largest slot position, not its own, in both packages."""
    jc, tc, params, model = _setup("yi-6b")
    first, late = _queue(jc, 2, [9, 4])
    jsrv = jlaunch.BatchServer(jc, params, 2, 32)
    tsrv = tlaunch.BatchServer(model, 2, 32)
    for srv, mod in ((jsrv, jlaunch), (tsrv, tlaunch)):
        srv.admit(mod.Request(0, first))
        for _ in range(3):
            srv.step()
        srv.admit(mod.Request(1, late))
        srv.step()
    assert list(tsrv.pos) == list(jsrv.pos) == [13, 5]
    _close_caches(tc, tsrv.cache, jsrv.cache)
    k = tsrv.cache[0]["k"][1]                 # the late slot's first layer
    assert k[12].abs().sum() > 0              # written at the largest position
    assert not k[4:12].any()                  # its own rows stay empty
    assert [r.generated for r in tsrv.slots] == [r.generated
                                                  for r in jsrv.slots]
