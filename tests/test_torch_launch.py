"""The port's launch layer (meshes, specs, placement, elastic re-placement,
the step factories and the serve CLI) against the JAX package's, on the CPU.

Specs, mesh divisors and placed-search results are equal exactly. The
reference's specs on 8-device meshes, its shard-mesh divisors and its
``NamedSharding.devices_indices_map`` come from one subprocess with 8
virtual CPU devices, as ``tests/test_elastic.py`` builds its meshes; the
port builds its meshes over repeated CPU devices.
"""
import gc
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import repro.configs as jcfg
from repro.core import index as jhix
from repro.models import transformer as jt
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.core.predicate import intervals as jintervals
from repro.launch import steps as jsteps
from repro.launch.mesh import make_shard_mesh as jmake_shard_mesh
from repro.launch.shardings import _fit as jfit
from repro.launch.shardings import param_spec as jparam_spec
from repro.launch.shardings import place_sharded as jplace_sharded
from repro.storage.table import PagedTable as JTable
from jax.sharding import PartitionSpec as JP
import repro_torch.configs as tcfg
from repro_torch import convert
from repro_torch.core import index as thix
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.launch import serve as tlaunch
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import (batch_axes, current_mesh,
                                     make_host_mesh, make_mesh_compat,
                                     make_production_mesh, make_shard_mesh)
from repro_torch.launch.shardings import (P, NamedSharding, PlacedTensor,
                                          _batch_spec_axes, _fit,
                                          make_opt_shardings,
                                          make_param_shardings, param_spec,
                                          place, place_sharded,
                                          reference_path, replicated,
                                          train_batch_shardings,
                                          tree_cache_shardings)
from repro_torch.models import partition as tpartition
from repro_torch.models import transformer as tt
from repro_torch.models import serve as ts
from repro_torch.runtime.elastic import reshard_for_mesh, validate_divisibility
from repro_torch.storage.table import PagedTable as TTable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SPEC_ARCHS = ["llama4-maverick-400b-a17b", "qwen2-moe-a2.7b",
              "recurrentgemma-9b", "rwkv6-3b", "qwen2-vl-7b", "stablelm-3b"]
MESHES = {"dp_tp": ((2, 4), ("data", "model")),
          "pod": ((2, 2, 2), ("pod", "data", "model"))}
ELASTIC = {"w": ((8, 16), ("data", "model")), "b": ((16,), ("model",)),
           "c": ((6,), ("data",)), "r": ((4, 3), ())}


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


def _cpu_mesh(shape, axes):
    return make_mesh_compat(shape, axes, [CPU] * int(np.prod(shape)))


# ---------------------------------------------------------------------------
# the reference on 8 virtual devices (one subprocess for the module)
# ---------------------------------------------------------------------------

_REF_PROG = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import numpy as np
    import jax
    from jax.sharding import PartitionSpec as P
    from repro.configs import get_config
    from repro.launch import steps
    from repro.launch.mesh import make_mesh_compat, make_shard_mesh
    from repro.launch.shardings import (make_opt_shardings,
        make_param_shardings, train_batch_shardings, tree_cache_shardings)
    from repro.models import partition, transformer
    from repro.runtime.elastic import reshard_for_mesh

    def spec(s):
        return [list(a) if isinstance(a, tuple) else a for a in s.spec]

    def name(path):
        out = []
        for k in path:
            out.append(str(k.key) if hasattr(k, "key") else f"[{k.idx}]")
        return "/".join(out)

    def opt_name(path):
        return "/".join(str(getattr(k, "name", getattr(k, "key", None)))
                        if not hasattr(k, "idx") else f"[{k.idx}]"
                        for k in path)

    MESHES = MESHES_SRC
    ELASTIC = ELASTIC_SRC
    out = {"params": {}, "cache": {}, "batch": {}, "shard_mesh": {},
           "elastic": {}, "opt": {}}
    for mname, (shape, axes) in MESHES.items():
        mesh = make_mesh_compat(shape, axes)
        for arch in ARCHS_SRC:
            cfg = get_config(arch).reduced(d_model=128, num_heads=4,
                                           num_kv_heads=4, head_dim=32,
                                           vocab_size=512, d_ff=256,
                                           num_layers=5)
            sh = make_param_shardings(cfg, mesh, steps.params_shape(cfg))
            out["params"][f"{mname}/{arch}"] = {
                name(p): spec(s) for p, s in
                jax.tree_util.tree_leaves_with_path(sh)}
            for md in ("float32", "int8"):
                osh = make_opt_shardings(cfg, mesh, steps.opt_state_shape(
                    cfg, steps.params_shape(cfg), md))
                out["opt"][f"{mname}/{arch}/{md}"] = {
                    opt_name(p): spec(s) for p, s in
                    jax.tree_util.tree_leaves_with_path(osh)}
            for b in (8, 3):
                csh = tree_cache_shardings(
                    cfg, mesh, steps.cache_shape(cfg, b, 64), b)
                out["cache"][f"{mname}/{arch}/{b}"] = {
                    name(p): spec(s) for p, s in
                    jax.tree_util.tree_leaves_with_path(csh)}
        for over in (None, ("pod", "data", "model")):
            partition.BATCH_AXES_OVERRIDE = over
            for b in (1, 2, 4, 6, 8, 16):
                for arch in ("smollm-360m", "musicgen-large"):
                    bs = train_batch_shardings(get_config(arch), mesh, b)
                    out["batch"][f"{mname}/{over}/{b}/{arch}"] = {
                        k: spec(v) for k, v in bs.items()}
        partition.BATCH_AXES_OVERRIDE = None
    for k in range(1, 13):
        out["shard_mesh"][k] = make_shard_mesh(k).shape["data"]
    for shape in ((4, 2), (2, 1)):
        mesh = make_mesh_compat(shape, ("data", "model"))
        tree = {k: np.arange(np.prod(s), dtype=np.float32).reshape(s)
                for k, (s, _) in ELASTIC.items()}
        placed = reshard_for_mesh(tree, {k: P(*a) for k, (_, a)
                                         in ELASTIC.items()}, mesh)
        for k, arr in placed.items():
            imap = arr.sharding.devices_indices_map(arr.shape)
            out["elastic"][f"{shape}/{k}"] = {
                "total": float(arr.sum()),
                "devices": len(arr.sharding.device_set),
                "blocks": len({str(v) for v in imap.values()}),
                "index": [[list(s.indices(d))[:2]
                           for s, d in zip(imap[mesh.devices[pos]], arr.shape)]
                          for pos in np.ndindex(*mesh.devices.shape)]}
    # the reduced smollm's forward and loss under a 2-device data mesh
    cfg = get_config("smollm-360m").reduced()
    params = transformer.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(9)
    b, s = 4, 12
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "positions": np.broadcast_to(np.arange(s)[None], (b, s)).astype(
                 np.int32).copy()}
    with make_mesh_compat((2, 1), ("data", "model")):
        logits = jax.jit(lambda p, x, q: transformer.forward(
            cfg, p, x, q, remat=False))(params, batch["inputs"],
                                        batch["positions"])
        loss = jax.jit(lambda p, bt: transformer.loss_fn(cfg, p, bt))(
            params, batch)
    out["mesh_forward"] = {"logits": np.asarray(logits).tolist(),
                           "loss": float(loss)}
    print(json.dumps(out))
""").replace("MESHES_SRC", repr(MESHES)).replace(
    "ELASTIC_SRC", repr(ELASTIC)).replace("ARCHS_SRC", repr(SPEC_ARCHS))


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


def _spec_json(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_mesh_builders_and_divisors(ref):
    m = make_host_mesh(2, 3, devices=[CPU] * 6)
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    assert batch_axes(m) == ("data",)
    assert batch_axes(_cpu_mesh((2, 2, 2), ("pod", "data", "model"))) == (
        "pod", "data")
    prod = make_production_mesh(multi_pod=True, devices=[CPU] * 512)
    assert prod.shape == {"pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="needs 256 devices"):
        make_production_mesh(devices=[CPU] * 255)
    with pytest.raises(ValueError, match="num_shards"):
        make_shard_mesh(0, devices=[CPU])
    # the reference's divisor rule: with 8 devices (its subprocess), and
    # with this process's one device
    for k in range(1, 13):
        assert make_shard_mesh(k, devices=[CPU] * 8).shape["data"] == \
            ref["shard_mesh"][str(k)]
        assert make_shard_mesh(k, devices=[CPU]).shape["data"] == \
            jmake_shard_mesh(k).shape["data"]
    for n in range(1, 9):
        for k in range(1, 13):
            d = make_shard_mesh(k, devices=[CPU] * n).shape["data"]
            assert d == max(j for j in range(1, min(k, n) + 1) if k % j == 0)


def test_device_none_means_every_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_shard_mesh(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--reduced", "--requests", "1"])


def test_mesh_context_and_constrain_batch():
    x = torch.arange(12.0).reshape(4, 3)
    assert current_mesh() is None
    assert tpartition.constrain_batch(x) is x
    one = _cpu_mesh((1, 1), ("data", "model"))
    with one:
        assert current_mesh() is one
        assert torch.equal(tpartition.constrain_batch(x), x)
        two = _cpu_mesh((2, 1), ("data", "model"))
        with two:
            assert current_mesh() is two
            y = x[:3]                       # 3 rows do not divide: as is
            assert tpartition.constrain_batch(y) is y
            # both positions are the CPU: the whole batch stays on it
            assert torch.equal(tpartition.constrain_batch(x), x)
        assert current_mesh() is one
    assert current_mesh() is None


def test_constrain_batch_refuses_a_mesh_of_distinct_devices():
    """Two distinct devices (here the CPU and a meta device standing in for
    a second card) whose data axis divides the batch: splitting it would
    need a process group, so it is refused; a batch it does not divide
    passes as the reference leaves it."""
    x = torch.arange(12.0).reshape(4, 3)
    mesh = make_host_mesh(data=2, model=1,
                          devices=[CPU, torch.device("meta")])
    with mesh:
        with pytest.raises(NotImplementedError, match="distinct devices"):
            tpartition.constrain_batch(x)
        y = x[:3]
        assert tpartition.constrain_batch(y) is y


def test_forward_and_loss_under_a_two_position_mesh_equal_reference(ref):
    """Under ``make_host_mesh(data=2, model=1, devices=[cpu, cpu])`` the
    reduced smollm's forward and ``loss_fn`` equal their values outside
    the mesh exactly, and the reference's under its 2-device data mesh
    (``with_sharding_constraint`` on 2 of the subprocess's 8 virtual
    devices) within the models' 2e-4."""
    jc = jcfg.get_config("smollm-360m").reduced()
    tc = tcfg.get_config("smollm-360m").reduced()
    params = jax.tree_util.tree_map(
        np.asarray, jt.init_params(jc, jax.random.PRNGKey(0)))
    model = convert.model_from_reference(tc, params, device="cpu")
    rng = np.random.default_rng(9)
    b, s = 4, 12
    batch = {"inputs": rng.integers(0, tc.vocab_size, (b, s)).astype(np.int32),
             "labels": rng.integers(0, tc.vocab_size, (b, s)).astype(np.int32),
             "positions": np.broadcast_to(np.arange(s)[None], (b, s)).astype(
                 np.int32).copy()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = tt.forward(model, tb["inputs"], tb["positions"])
        loss = tt.loss_fn(model, tb)
        with make_host_mesh(data=2, model=1, devices=[CPU, CPU]):
            m_logits = tt.forward(model, tb["inputs"], tb["positions"])
            m_loss = tt.loss_fn(model, tb)
    assert torch.equal(m_logits, logits) and torch.equal(m_loss, loss)
    want = ref["mesh_forward"]
    np.testing.assert_allclose(m_logits.numpy(),
                               np.asarray(want["logits"], np.float32),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(m_loss), want["loss"], rtol=2e-4,
                               atol=2e-4)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

class _K:  # fake path keys, as tests/test_launch.py builds them
    def __init__(self, key):
        self.key = key


@pytest.mark.parametrize("arch,path,want", [
    ("llama4-maverick-400b-a17b", ("units", "b1_moe", "moe", "w_gate"),
     (None, "model", "data", None)),
    ("qwen2-moe-a2.7b", ("units", "b0_moe", "moe", "w_gate"),
     (None, None, "data", "model")),
    ("qwen2-moe-a2.7b", ("units", "b0_moe", "moe", "w_down"),
     (None, None, "model", "data")),
    ("qwen2-moe-a2.7b", ("units", "b0_moe", "moe", "shared", "w_gate"),
     (None, "data", "model")),
    ("llama4-maverick-400b-a17b", ("units", "b0_attn", "norm1", "scale"), ()),
    ("smollm-360m", ("embed",), ("model", "data")),
    ("qwen2-vl-7b", ("frontend_proj",), ("data", "model")),
    ("recurrentgemma-9b", ("extra", "[0]", "rec", "w_out"), ("model", "data")),
])
def test_param_spec_rules_equal_reference(arch, path, want):
    """The cases of tests/test_launch.py, and a few more, against the
    reference's ``param_spec`` with the same path keys."""
    keys = tuple(_K(k) for k in path)
    got = param_spec(tcfg.get_config(arch), keys, None)
    assert got == P(*want)
    assert tuple(got) == tuple(jparam_spec(jcfg.get_config(arch), keys, None))


def test_fit_equals_reference():
    mesh = _cpu_mesh((2, 4), ("data", "model"))

    class JMesh:                       # the reference's _fit reads .shape only
        shape = {"data": 2, "model": 4}

    cases = [(P("data", "model"), (8, 12)), (P("data", "model"), (3, 8)),
             (P(("data", "model"), None), (16, 5)), (P("model"), (6, 4, 2)),
             (P(), (4,)), (P(None, "data"), (1, 7))]
    for spec, shape in cases:
        assert tuple(_fit(mesh, spec, shape)) == tuple(
            jfit(JMesh, JP(*spec), shape))


@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_and_cache_shardings_equal_reference(ref, mname, arch):
    """Every parameter's and cache leaf's spec equals the reference's on the
    same mesh, without the reference's stacked unit axis."""
    mesh = _cpu_mesh(*MESHES[mname])
    cfg = tcfg.get_config(arch).reduced(d_model=128, num_heads=4,
                                        num_kv_heads=4, head_dim=32,
                                        vocab_size=512, d_ff=256, num_layers=5)
    want = ref["params"][f"{mname}/{arch}"]
    got = make_param_shardings(cfg, mesh, tsteps.params_shape(cfg))
    seen = set()
    for name, sh in got.items():
        path = reference_path(cfg, name)
        key = "/".join(path)
        spec = want[key][1:] if path[0] == "units" else want[key]
        assert _spec_json(sh.spec) == spec, name
        seen.add(key)
    assert seen == set(want)
    for b in (8, 3):
        want = ref["cache"][f"{mname}/{arch}/{b}"]
        got = tree_cache_shardings(cfg, mesh, tsteps.cache_shape(cfg, b, 64), b)
        unit_layers = cfg.num_units * cfg.unit_len
        n = 0
        for i, layer in enumerate(got):
            for leaf, sh in layer.items():
                if i < unit_layers:
                    j = i % cfg.unit_len
                    spec = want[f"units/b{j}_{cfg.block_pattern[j]}/{leaf}"][1:]
                else:
                    spec = want[f"extra/[{i - unit_layers}]/{leaf}"]
                assert _spec_json(sh.spec) == spec, (i, leaf)
                n += 1
        assert n >= len(want)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
@pytest.mark.parametrize("mname", sorted(MESHES))
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_opt_shardings_equal_reference(ref, mname, arch, moment_dtype):
    """Every moment's spec (an int8 moment's ``q`` and ``s``) and the step's
    equal the reference's ``make_opt_shardings`` on the same mesh, without
    the stacked unit axis."""
    mesh = _cpu_mesh(*MESHES[mname])
    cfg = tcfg.get_config(arch).reduced(d_model=128, num_heads=4,
                                        num_kv_heads=4, head_dim=32,
                                        vocab_size=512, d_ff=256, num_layers=5)
    want = ref["opt"][f"{mname}/{arch}/{moment_dtype}"]
    got = make_opt_shardings(cfg, mesh, tsteps.opt_state_shape(
        cfg, tsteps.params_shape(cfg), moment_dtype))
    assert _spec_json(got.step.spec) == want["step"]
    seen = {"step"}
    for field in ("mu", "nu"):
        for name, sh in getattr(got, field).items():
            path = reference_path(cfg, name)
            parts = ({"": sh} if moment_dtype == "float32" else
                     {f"/{k}": v for k, v in sh.items()})
            for suffix, leaf in parts.items():
                key = "/".join((field, *path)) + suffix
                spec = want[key][1:] if path[0] == "units" else want[key]
                assert _spec_json(leaf.spec) == spec, key
                seen.add(key)
    assert seen == set(want)


def test_batch_shardings_equal_reference(ref):
    for mname, (shape, axes) in MESHES.items():
        mesh = _cpu_mesh(shape, axes)
        for over in (None, ("pod", "data", "model")):
            tpartition.BATCH_AXES_OVERRIDE = over
            try:
                for b in (1, 2, 4, 6, 8, 16):
                    for arch in ("smollm-360m", "musicgen-large"):
                        got = train_batch_shardings(tcfg.get_config(arch),
                                                    mesh, b)
                        want = ref["batch"][f"{mname}/{over}/{b}/{arch}"]
                        assert {k: _spec_json(v.spec) for k, v in
                                got.items()} == want, (mname, over, b, arch)
            finally:
                tpartition.BATCH_AXES_OVERRIDE = None
    assert replicated(mesh).spec == P()
    assert _batch_spec_axes(mesh, 3) is None


# ---------------------------------------------------------------------------
# placement and the placed sharded searches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded_pair():
    values = np.random.default_rng(41).uniform(0, 1000, 1000).astype(np.float32)
    j = JSharded.create(JTable.from_values(values.copy(), page_card=8,
                                           spare_pages=64),
                        num_shards=4, resolution=32, density=0.25)
    t = TSharded.create(TTable.from_values(values.copy(), page_card=8,
                                           spare_pages=64),
                        num_shards=4, resolution=32, density=0.25,
                        device="cpu")
    rng = np.random.default_rng(42)
    spans = [(float(lo), float(lo + w)) for lo, w in
             zip(rng.uniform(0, 1000, 12), rng.uniform(0, 300, 12))]
    spans += [(5.0, 1.0), (2000.0, 3000.0), (-1e30, 1e30)]
    return (j, t, [JPred.between(*s) for s in spans],
            [TPred.between(*s) for s in spans])


def _reference_results(j, jpreds, top_k):
    """The flow of tests/test_partition.py's placed-search test: the
    reference's own placement (one device here) and search."""
    mesh = jmake_shard_mesh(j.num_shards)
    keys, valid = j._slabs()
    st, k, v = jplace_sharded(mesh, j.state, keys, valid)
    qbms = j._query_bitmaps(jpreds)
    los, his = jintervals(jpreds)
    dense = jhix.search_many_sharded(st.shards, qbms, k, v, los, his)
    compact = jhix.search_compact_many_sharded(
        st.shards, qbms, k, v, los, his, max_selected=j.spec.pages_per_shard,
        top_k=top_k)
    return dense, compact


@pytest.mark.parametrize("n_devices,blocks", [(1, 1), (2, 2), (3, 2), (4, 4),
                                              (8, 4)])
def test_placed_sharded_searches_equal_reference(sharded_pair, n_devices,
                                                 blocks):
    """``place_sharded`` on ``make_shard_mesh(4)`` over 1-8 CPU entries:
    plain tensors on one entry; otherwise each shard block is searched where
    it lives and the results are summed on the first. Every field equals the
    reference's and the unplaced port's."""
    j, t, jpreds, tpreds = sharded_pair
    mesh = make_shard_mesh(t.num_shards, devices=[CPU] * n_devices)
    assert mesh.shape["data"] == blocks
    keys, valid = t._slabs()
    st, k, v = place_sharded(mesh, t.state, keys, valid)
    if blocks == 1:
        assert isinstance(k, torch.Tensor) and isinstance(
            st.shards.bitmaps, torch.Tensor)
    else:
        assert isinstance(k, PlacedTensor) and k.num_blocks == blocks
        assert st.summaries.num_blocks == blocks
    qbms, los, his = t._query_bitmaps(tpreds)
    jd, _ = _reference_results(j, jpreds, top_k=0)
    dense = thix.search_many_sharded(st.shards, qbms, k, v, los, his)
    plain = thix.search_many_sharded(t.state.shards, qbms, keys, valid, los,
                                     his)
    for name in jd._fields:
        want = np.asarray(getattr(jd, name))
        np.testing.assert_array_equal(getattr(dense, name).numpy(), want, name)
        np.testing.assert_array_equal(getattr(plain, name).numpy(), want, name)
    for top_k in (5, 0):
        _, jc = _reference_results(j, jpreds, top_k=top_k)
        got = thix.search_compact_many_sharded(
            st.shards, qbms, k, v, los, his,
            max_selected=t.spec.pages_per_shard, top_k=top_k)
        for name in jc._fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(jc, name)), name)
    # a mesh that does not divide the shards replicates: one block, exact
    if n_devices == 3:
        st3, k3, v3 = place_sharded(_cpu_mesh((3,), ("data",)), t.state,
                                    keys, valid)
        assert k3.num_blocks == 1
        got = thix.search_many_sharded(st3.shards, qbms, k3, v3, los, his)
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(jd.counts))


def test_placed_tensor_blocks_and_assembly():
    mesh = _cpu_mesh((2, 4), ("data", "model"))
    x = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    pt = place(x, NamedSharding(mesh, P("data", "model")))
    assert pt.num_blocks == 8 and torch.equal(pt.assemble(), x)
    assert torch.equal(pt.block((1, 2)), x[4:8, 6:9])
    rep = place(x, NamedSharding(mesh, P()))
    assert rep.num_blocks == 1 and rep.block((0, 0)) is rep.block((1, 3))
    with pytest.raises(ValueError, match="does not divide"):
        place(x[:7], NamedSharding(mesh, P("model")))
    plain = place(x, NamedSharding(_cpu_mesh((1,), ("data",)), P("data")))
    assert isinstance(plain, torch.Tensor) and torch.equal(plain, x)


# ---------------------------------------------------------------------------
# elastic re-placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 2), (2, 1)])
def test_reshard_for_mesh_blocks_equal_jax_indices(ref, shape):
    """The reference's elastic meshes (8 and 2 entries): each leaf's block
    ranges equal JAX's ``devices_indices_map`` position by position, the
    sums are exact, the block counts are the reference's, and a spec that
    does not divide (``c``: 6 rows over 4) falls back to replication."""
    mesh = _cpu_mesh(shape, ("data", "model"))
    tree = {k: np.arange(np.prod(s), dtype=np.float32).reshape(s)
            for k, (s, _) in ELASTIC.items()}
    specs = {k: P(*a) for k, (_, a) in ELASTIC.items()}
    placed = reshard_for_mesh(tree, specs, mesh)
    for k, arr in placed.items():
        want = ref["elastic"][f"{shape}/{k}"]
        imap = arr.indices_map()
        got = [[[s.start, s.stop] for s in imap[pos]]
               for pos in np.ndindex(*mesh.devices.shape)]
        assert got == want["index"], k
        assert float(arr.assemble().sum()) == want["total"]
        assert arr.num_blocks == want["blocks"], k
        assert torch.equal(arr.assemble(), torch.from_numpy(tree[k]))
    # the reference test's count: "w" spans every device, 8 or 2
    assert placed["w"].num_blocks == ref["elastic"][f"{shape}/w"]["devices"]
    assert placed["w"].num_blocks == mesh.size
    assert validate_divisibility((6,), P("data"), mesh) == (6 % shape[0] == 0)
    one = reshard_for_mesh({"w": tree["w"]}, P("data"), _cpu_mesh((1, 1), (
        "data", "model")))
    assert isinstance(one["w"], torch.Tensor)


# ---------------------------------------------------------------------------
# steps and the serve CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "recurrentgemma-9b",
                                  "musicgen-large"])
def test_abstract_shapes_equal_reference(arch):
    jc = jcfg.get_config(arch)
    tc = tcfg.get_config(arch)
    model = tsteps.params_shape(tc)                  # the published widths
    assert all(p.device.type == "meta" for p in model.parameters())
    want = {"/".join(str(getattr(k, "key", f"[{getattr(k, 'idx', '')}]"))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                jsteps.params_shape(jc))}
    for name, p in model.named_parameters():
        path = reference_path(tc, name)
        leaf = want["/".join(path)]
        shape = leaf.shape[1:] if path[0] == "units" else leaf.shape
        assert tuple(p.shape) == tuple(shape), name
        assert str(p.dtype).replace("torch.", "") == str(leaf.dtype), name
    cache = tsteps.cache_shape(tc, 4, 128)
    ref_cache = jsteps.cache_shape(jc, 4, 128)
    unit_layers = tc.num_units * tc.unit_len
    for i, layer in enumerate(cache):
        for leaf, t in layer.items():
            if i < unit_layers:
                j = i % tc.unit_len
                r = ref_cache["units"][f"b{j}_{tc.block_pattern[j]}"][leaf]
                shape = r.shape[1:]
            else:
                r = ref_cache["extra"][i - unit_layers][leaf]
                shape = r.shape
            assert tuple(t.shape) == tuple(shape) and t.device.type == "meta"
            assert str(t.dtype).replace("torch.", "") == str(r.dtype)
    for shape in jcfg.SHAPES.values():
        for kind in ("train", "prefill", "decode"):
            got = tsteps.input_specs(tc, shape, kind)
            want = jsteps.input_specs(jc, shape, kind)
            assert sorted(got) == sorted(want)
            for k in got:
                assert tuple(got[k].shape) == tuple(want[k].shape)
                assert str(got[k].dtype).replace("torch.", "") == str(
                    want[k].dtype)


def test_step_factories_equal_direct_calls():
    tc = tcfg.get_config("smollm-360m").reduced()
    model = tt.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    inputs = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 6)))
    pos = torch.arange(6)[None].expand(2, 6)
    want, wcache = ts.prefill(model, inputs, pos, 12)
    got, gcache = tsteps.make_prefill_step(tc, 12)(
        model, {"inputs": inputs, "positions": pos})
    assert torch.equal(got, want)
    tok = torch.argmax(got, -1)[:, None]
    want, _ = ts.decode_step(model, wcache, tok, 6)
    got, _ = tsteps.make_decode_step(tc)(model, gcache, tok, 6)
    assert torch.equal(got, want)


def test_serve_cli_on_the_cpu(capsys):
    finished = tlaunch.main(["--arch", "smollm-360m", "--reduced", "--device",
                             "cpu", "--requests", "3", "--batch", "2",
                             "--prompt-len", "8", "--gen", "6"])
    assert sorted(r.rid for r in finished) == [0, 1, 2]
    assert all(len(r.generated) == 6 and r.done for r in finished)
    assert all(0 <= t < 256 for r in finished for t in r.generated)
    assert "served 3 requests / 18 tokens" in capsys.readouterr().out
    bf = tlaunch.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu",
                       "--dtype", "bfloat16", "--requests", "1", "--batch",
                       "1", "--prompt-len", "4", "--gen", "2"])
    assert len(bf[0].generated) == 2
