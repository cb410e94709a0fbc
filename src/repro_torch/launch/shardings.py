"""Partition specs for parameters, inputs and caches, and tensor placement
(port of ``repro.launch.shardings``).

Layout policy, as the reference's:
  * 2-D param sharding: "width" dims (d_model) over ``data``, "parallel" dims
    (heads*hd, d_ff, vocab, experts) over ``model``; replicated over ``pod``.
  * MoE experts shard over ``model`` when divisible (llama4 128/16) else TP
    inside the expert FFN (qwen2-moe 60 experts).
  * Batch dims shard over ("pod","data") when divisible, falling back to
    "data" or replication.
  * Decode KV caches shard sequence over ``model`` and batch over data axes.
Every rule is fitted to the mesh: non-divisible dims degrade to replication.

``P`` is a partition spec as a tuple (one entry per dim: None, an axis name,
or a tuple of names). Placing a tensor on a mesh (``place``) gives each mesh
position its block of the sharded dims: on a one-entry mesh the plain tensor
on that device, otherwise a ``PlacedTensor``. The port's parameters and caches
are per layer, so their specs are the reference's without the stacked unit
axis.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import index as hix
from repro_torch.core.partition import ShardedHippoState
from repro_torch.launch.mesh import Mesh, batch_axes


class P(tuple):
    """A partition spec: ``P("data", None)`` is the tuple ("data", None).
    As JAX's, an entry of one axis name is that name and an empty one None:
    ``P(("data",), ())`` is ("data", None)."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            (a[0] if len(a) == 1 else a or None) if isinstance(a, tuple)
            else a for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class NamedSharding:
    """A spec on a mesh."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)


def _axis_size(mesh: Mesh, axes) -> int:
    if axes is None:
        return 1
    axes = (axes,) if isinstance(axes, str) else axes
    return int(np.prod([mesh.shape[a] for a in axes]))


def _fit(mesh: Mesh, spec: P, shape: tuple) -> P:
    """Drop spec axes that don't divide the corresponding dim."""
    out = []
    for dim, axes in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if axes is not None and dim % _axis_size(mesh, axes) == 0:
            out.append(axes)
        else:
            out.append(None)
    return P(*out)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def block_slices(mesh: Mesh, spec: P, shape: tuple, position: tuple) -> tuple:
    """The block of a tensor of ``shape`` that mesh ``position`` holds under
    ``spec``: one slice a dim (a dim over axes (a, b) splits into
    size(a)*size(b) blocks, block index i_a*size(b) + i_b, as JAX's)."""
    out = []
    for k, dim in enumerate(shape):
        axes = spec[k] if k < len(spec) else None
        if axes is None:
            out.append(slice(0, dim))
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        n, idx = 1, 0
        for a in axes:
            ai = mesh.axis_names.index(a)
            idx = idx * mesh.devices.shape[ai] + position[ai]
            n *= mesh.devices.shape[ai]
        if dim % n:
            raise ValueError(f"dim {k} of {tuple(shape)} does not divide over "
                             f"{axes} ({n} blocks)")
        step = dim // n
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


class PlacedTensor:
    """A tensor on a mesh of more than one entry: mesh position ``pos`` holds
    the block ``indices_map()[pos]`` on ``mesh.devices[pos]``. Positions that
    hold the same block on the same device share one tensor."""

    def __init__(self, x: torch.Tensor, mesh: Mesh, spec: P):
        self.mesh, self.spec = mesh, P(*spec)
        self.shape, self.dtype = tuple(x.shape), x.dtype
        self._index = {}
        self._blocks = {}
        held = {}
        for pos in np.ndindex(*mesh.devices.shape):
            sl = block_slices(mesh, self.spec, self.shape, pos)
            dev = mesh.devices[pos]
            key = (tuple((s.start, s.stop) for s in sl), dev)
            if key not in held:
                held[key] = x[sl].contiguous().to(dev)
            self._index[pos] = sl
            self._blocks[pos] = held[key]

    def block(self, position: tuple) -> torch.Tensor:
        return self._blocks[tuple(position)]

    def indices_map(self) -> dict:
        """mesh position -> the block's slices (JAX's ``devices_indices_map``
        keyed by position, since devices may repeat)."""
        return dict(self._index)

    def distinct_blocks(self) -> list[tuple[tuple, tuple]]:
        """(slices, first position holding them) of every distinct block, in
        index order."""
        first = {}
        for pos, sl in self._index.items():
            first.setdefault(tuple((s.start, s.stop) for s in sl), (sl, pos))
        return [first[k] for k in sorted(first)]

    @property
    def num_blocks(self) -> int:
        return len(self.distinct_blocks())

    def assemble(self) -> torch.Tensor:
        """The whole tensor, on the first position's device."""
        dev = self.mesh.devices.flat[0]
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for sl, pos in self.distinct_blocks():
            out[sl] = self.block(pos).to(dev)
        return out


def place(x: torch.Tensor, sharding: NamedSharding):
    """x laid out by ``sharding``: the plain tensor on the device of a
    one-entry mesh, else a ``PlacedTensor``."""
    mesh = sharding.mesh
    if mesh.size == 1:
        return x.to(mesh.devices.flat[0])
    return PlacedTensor(x, mesh, sharding.spec)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

_COL = {  # (..., d_in, parallel_out): d_in over data, out over model
    "wq", "wk", "wv", "w_gate", "w_up", "w_x", "w_r", "w_i",
    "w_k", "w_v", "w_g", "cm_k", "cm_r", "decay_a", "mu_a", "lm_head",
}
_ROW = {  # (..., parallel_in, d_out): in over model, d_out over data
    "wo", "w_down", "w_out", "w_o", "cm_v", "decay_b", "mu_b",
}


def param_spec(cfg, path: tuple, leaf) -> P:
    """The reference's spec for one parameter leaf, identified by its path in
    the reference's tree (``units`` leaves carry the stacked unit axis)."""
    names = [getattr(k, "key", getattr(k, "name", str(k))) for k in path]
    name = names[-1]
    stacked = "units" in names            # leading num_units dim
    lead = (None,) if stacked else ()
    expert = any("moe" in n for n in names) and name in (
        "w_gate", "w_up", "w_down") and not any(n == "shared" for n in names)

    if name == "embed":
        return P("model", "data")
    if name == "frontend_proj":
        return P("data", "model")
    if name == "lm_head":
        return P("data", "model")
    if expert:
        # (E, d, f) or (E, f, d)
        if cfg.num_experts % 16 == 0:     # EP over model
            return P(*lead, "model", "data", None)
        if name in ("w_gate", "w_up"):    # TP inside expert
            return P(*lead, None, "data", "model")
        return P(*lead, None, "model", "data")
    if name in _COL:
        return P(*lead, "data", "model")
    if name in _ROW:
        return P(*lead, "model", "data")
    return P()  # norms, scalars, biases, router — replicate


def reference_path(cfg, name: str) -> tuple:
    """The reference's tree path of a ``Transformer`` parameter name:
    ``blocks.i.<rest>`` is ``units/b{j}_{kind}/<rest>`` (stacked) for the
    unit layers and ``extra/[e]/<rest>`` for the leftover ones."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return tuple(parts)
    i = int(parts[1])
    unit_layers = cfg.num_units * cfg.unit_len
    if i < unit_layers:
        j = i % cfg.unit_len
        return ("units", f"b{j}_{cfg.block_pattern[j]}", *parts[2:])
    return ("extra", f"[{i - unit_layers}]", *parts[2:])


def _leaf_sharding(cfg, mesh: Mesh, name: str, shape: tuple
                   ) -> NamedSharding:
    """The reference's spec of parameter ``name`` without the stacked unit
    axis, fitted to ``shape``."""
    path = reference_path(cfg, name)
    spec = param_spec(cfg, path, None)
    if path[0] == "units" and len(spec):
        spec = P(*spec[1:])
    return NamedSharding(mesh, _fit(mesh, spec, tuple(shape)))


def make_param_shardings(cfg, mesh: Mesh, model) -> dict:
    """{parameter name: NamedSharding} for a ``Transformer`` (a meta one from
    ``launch.steps.params_shape`` allocates nothing): the reference's spec
    without the stacked unit axis, fitted to the parameter's shape."""
    return {name: _leaf_sharding(cfg, mesh, name, leaf.shape)
            for name, leaf in model.named_parameters()}


def make_opt_shardings(cfg, mesh: Mesh, opt_shape):
    """Shardings for an ``AdamWState`` (``launch.steps.opt_state_shape``,
    any moment dtype), keyed as its moments are: a moment takes its
    parameter's spec; an int8 moment's ``q`` shards like its parameter and
    its ``s`` (a (..., 1) row scale) drops the trailing axis's spec by
    fitting."""
    def one(name, leaf):
        if isinstance(leaf, dict):
            return {k: one(name, v) for k, v in leaf.items()}
        return _leaf_sharding(cfg, mesh, name, leaf.shape)

    return type(opt_shape)(
        step=replicated(mesh),
        mu={n: one(n, m) for n, m in opt_shape.mu.items()},
        nu={n: one(n, v) for n, v in opt_shape.nu.items()})


# ---------------------------------------------------------------------------
# input / batch / cache specs
# ---------------------------------------------------------------------------

def _batch_spec_axes(mesh: Mesh, batch: int):
    from repro_torch.models import partition
    if partition.BATCH_AXES_OVERRIDE:
        want = tuple(a for a in partition.BATCH_AXES_OVERRIDE
                     if a in mesh.axis_names)
        for k in range(len(want), 0, -1):  # longest dividing prefix
            if batch % _axis_size(mesh, want[:k]) == 0:
                return want[:k]
    ba = batch_axes(mesh)
    if ba and batch % _axis_size(mesh, ba) == 0:
        return ba
    if "data" in mesh.axis_names and batch % mesh.shape["data"] == 0:
        return "data"
    return None


def train_batch_shardings(cfg, mesh: Mesh, batch: int) -> dict:
    ba = _batch_spec_axes(mesh, batch)
    tok = NamedSharding(mesh, P(ba, None))
    if cfg.frontend != "tokens":
        tok = NamedSharding(mesh, P(ba, None, None))
    return {
        "inputs": tok,
        "labels": NamedSharding(mesh, P(ba, None)),
        "positions": NamedSharding(mesh, P(ba, None)),
    }


def tree_cache_shardings(cfg, mesh: Mesh, cache_shape: list, batch: int
                         ) -> list[dict]:
    """Per layer, {leaf: NamedSharding} for ``models.serve.init_cache``'s
    layout: KV caches shard sequence over ``model`` and batch over data axes;
    recurrent states shard their width dims over ``model``."""
    ba = _batch_spec_axes(mesh, batch)

    def one(name, leaf):
        nd = leaf.ndim
        if name in ("k", "v") and nd == 4:          # (B, S_c, KV, hd)
            spec = P(ba, "model", None, None)
        elif nd == 4:                               # rwkv wkv (B, H, hdk, hdv)
            spec = P(ba, None, "model", None)
        elif nd == 3:                               # rec conv (B, K-1, d)
            spec = P(ba, None, "model")
        elif nd == 2:                               # shift/h states (B, d)
            spec = P(ba, "model")
        else:
            spec = P()
        return NamedSharding(mesh, _fit(mesh, spec, tuple(leaf.shape)))

    return [{name: one(name, leaf) for name, leaf in layer.items()}
            for layer in cache_shape]


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ---------------------------------------------------------------------------
# Hippo shard placement (core.partition): shard axis over ``data``
# ---------------------------------------------------------------------------

def sharded_hippo_shardings(mesh: Mesh, state: ShardedHippoState
                            ) -> ShardedHippoState:
    """NamedShardings for a ``ShardedHippoState``: every stacked field's
    leading shard axis over the mesh ``data`` axis (fitted: replication when
    it does not divide), the per-shard bounds included. Placed so,
    ``core.index.search_many_sharded`` and ``search_compact_many_sharded``
    run each shard block where it lives and sum on the first device (the
    reference's cross-device psum)."""
    def one(leaf):
        return NamedSharding(mesh, _fit(mesh, P("data"), tuple(leaf.shape)))

    return ShardedHippoState(shards=hix.HippoState(*map(one, state.shards)),
                             summaries=one(state.summaries))


def shard_slab_shardings(mesh: Mesh, slab: torch.Tensor) -> NamedSharding:
    """Sharding for (S, PPS, page_card) table slabs: shard axis over data."""
    return NamedSharding(mesh, _fit(mesh, P("data"), tuple(slab.shape)))


def place_sharded(mesh: Mesh, state: ShardedHippoState, keys: torch.Tensor,
                  valid: torch.Tensor):
    """Place a ``ShardedHippoState`` and its table slabs on the mesh.

    Returns (state, keys, valid) to pass straight to ``search_many_sharded``
    or ``search_compact_many_sharded``: plain tensors on the device of a
    one-entry mesh, ``PlacedTensor``s over ``data`` on a larger one.
    """
    sh = sharded_hippo_shardings(mesh, state)
    st = ShardedHippoState(
        shards=hix.HippoState(*(place(leaf, s) for leaf, s
                                in zip(state.shards, sh.shards))),
        summaries=place(state.summaries, sh.summaries))
    return (st, place(keys, shard_slab_shardings(mesh, keys)),
            place(valid, shard_slab_shardings(mesh, valid)))
