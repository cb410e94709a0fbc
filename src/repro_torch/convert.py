"""Carry an index built by the JAX package into the port.

The reference's state is handed over as plain numpy arrays and Python
scalars (nothing of ``repro`` is imported here); ``from_arrays`` turns them
into a port ``ShardedHippoIndex`` and ``hippo_index_from_arrays`` into a
port ``HippoIndex``, each serving the same queries with the same results.
Keys of ``arrays``:

  bounds, bitmaps, starts, ends, sorted_order, slot_live, num_entries,
  num_slots, summarized_until
                    the ``HippoState`` fields; for a sharded index each with
                    its leading shard axis (bitmaps uint32 (S, E, W), or
                    (E, W) unsharded: the same bits are carried as int32)
  summaries         (S, W) uint32 per-shard summary bitmaps (sharded only)
  num_shards, pages_per_shard                  the ShardSpec (sharded only)
  resolution, density, page_card, max_slots, relocate_on_update
                                                            the HippoConfig
  keys, valid, num_pages, fill                               the PagedTable
  dirty, num_dirty  optional: the table's VACUUM notes (deletes pending
                    vacuum); absent, the table is clean
  bounds_epochs, summary
                    optional (sharded only): the per-shard bounds epochs of
                    a remapped index and its summary policy; absent, every
                    shard is at epoch 0 under "equal_mass"

The comparison surfaces cross the same way: ``btree_from_reference`` walks a
reference ``BPlusTree``'s nodes (read by attribute: ``root``, ``fanout``,
``io``, ``num_keys``; each node's ``leaf``, ``keys``, ``children``, ``ptrs``,
``next``) into the port's pools with its counters; ``minmax_from_arrays``
and ``kvindex_from_arrays`` take the reference's arrays.

Models cross as their parameter tree: ``model_from_reference`` takes the
reference's ``init_params`` tree as numpy arrays (nested dicts and lists;
``units/b{j}_{kind}`` leaves stacked over the units) and returns the port's
``Transformer`` with one block per layer; ``params_to_reference`` is its
inverse (CPU tensors, the dtypes kept); ``cache_to_reference`` restacks the
port's per-layer serving caches into the reference's layout as numpy. The
optimizer state crosses the same way: ``opt_state_to_reference`` restacks an
``AdamWState``'s name-keyed moments (any moment dtype; an int8 moment's
``q`` and ``s`` each) and ``opt_state_from_reference`` unstacks them.
``tree_to_reference`` restacks any {parameter name: value} dict (gradients,
say).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines.btree import BPlusTree, IOCounters
from repro_torch.core.baselines.minmax import MinMaxIndex
from repro_torch.core.hippo import HippoIndex
from repro_torch.core.index import HippoConfig, HippoState
from repro_torch.core.kvindex import KVIndex, KVIndexConfig
from repro_torch.core.partition import (ShardedHippoIndex, ShardedHippoState,
                                        ShardSpec)
from repro_torch.device import resolve_device
from repro_torch.launch.shardings import reference_path
from repro_torch.models.transformer import (Transformer, init_params,
                                            layer_kinds)
from repro_torch.optim.adamw import AdamWState
from repro_torch.storage.table import PagedTable


def _tensor(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(dev)


def _config(arrays: dict) -> HippoConfig:
    return HippoConfig(resolution=int(arrays["resolution"]),
                       density=float(arrays["density"]),
                       page_card=int(arrays["page_card"]),
                       max_slots=int(arrays["max_slots"]),
                       relocate_on_update=bool(arrays["relocate_on_update"]))


def _table(arrays: dict, page_card: int) -> PagedTable:
    keys = np.asarray(arrays["keys"], np.float32)
    dirty = np.asarray(arrays.get("dirty", np.zeros(keys.shape[0], bool)),
                       bool).copy()
    num_pages = int(arrays["num_pages"])
    num_dirty = int(arrays.get("num_dirty", dirty[:num_pages].sum()))
    return PagedTable(page_card=page_card, capacity_pages=keys.shape[0],
                      keys=keys.copy(),
                      valid=np.asarray(arrays["valid"], bool).copy(),
                      dirty=dirty, num_pages=num_pages,
                      fill=int(arrays["fill"]), num_dirty=num_dirty)


def from_arrays(arrays: dict, device=None) -> ShardedHippoIndex:
    """A port ``ShardedHippoIndex`` on ``device`` (None: the card) holding
    the given reference state and table."""
    dev = resolve_device(device)
    shards = HippoState(*(_tensor(arrays[f], dev) for f in HippoState._fields))
    state = ShardedHippoState(shards=shards,
                              summaries=_tensor(arrays["summaries"], dev))
    spec = ShardSpec(num_shards=int(arrays["num_shards"]),
                     pages_per_shard=int(arrays["pages_per_shard"]))
    cfg = _config(arrays)
    table = _table(arrays, cfg.page_card)
    if shards.bitmaps.shape[:2] != (spec.num_shards, cfg.max_slots):
        raise ValueError(f"bitmaps {tuple(shards.bitmaps.shape)} do not match "
                         f"{spec.num_shards} shards x {cfg.max_slots} slots")
    epochs = np.asarray(arrays.get("bounds_epochs",
                                   np.zeros(spec.num_shards)), np.int64)
    if epochs.shape != (spec.num_shards,):
        raise ValueError(f"bounds_epochs {epochs.shape} do not match "
                         f"{spec.num_shards} shards")
    return ShardedHippoIndex(cfg=cfg, spec=spec, state=state, table=table,
                             device=dev, bounds_epochs=epochs.copy(),
                             summary=str(arrays.get("summary", "equal_mass")))


def hippo_index_from_arrays(arrays: dict, device=None) -> HippoIndex:
    """A port ``HippoIndex`` on ``device`` (None: the card) holding the given
    unsharded reference state and table."""
    dev = resolve_device(device)
    state = HippoState(*(_tensor(arrays[f], dev) for f in HippoState._fields))
    cfg = _config(arrays)
    if state.bitmaps.shape[0] != cfg.max_slots:
        raise ValueError(f"bitmaps {tuple(state.bitmaps.shape)} do not match "
                         f"{cfg.max_slots} slots")
    return HippoIndex(cfg=cfg, state=state, table=_table(arrays, cfg.page_card),
                      device=dev)


def btree_from_reference(tree, device=None) -> BPlusTree:
    """A port ``BPlusTree`` on ``device`` (None: the card) with the
    reference tree's nodes, leaf chain, counters and key count."""
    levels = [[tree.root]]
    while not levels[-1][0].leaf:
        levels.append([c for node in levels[-1] for c in node.children])
    leaves = levels.pop()
    leaf_id = {id(node): i for i, node in enumerate(leaves)}
    leaf_next = np.array([leaf_id[id(node.next)] if node.next is not None
                          else -1 for node in leaves], np.int64)
    rows, below = [], leaf_id
    for level in reversed(levels):
        rows.append([(np.asarray(node.keys, np.float64),
                      np.array([below[id(c)] for c in node.children],
                               np.int64)) for node in level])
        below = {id(node): i for i, node in enumerate(level)}
    io = tree.io
    return BPlusTree.from_rows(
        tree.fanout, [(np.asarray(n.keys, np.float64),
                       np.asarray(n.ptrs, np.int64)) for n in leaves],
        leaf_next, rows,
        IOCounters(io.node_reads, io.node_writes, io.node_splits),
        tree.num_keys, device=device)


def minmax_from_arrays(mins, maxs, pages_per_range: int,
                       device=None) -> MinMaxIndex:
    """A port ``MinMaxIndex`` on ``device`` (None: the card) with the given
    per-range float32 mins and maxs."""
    dev = resolve_device(device)
    return MinMaxIndex(pages_per_range=int(pages_per_range),
                       mins=_tensor(np.asarray(mins, np.float32), dev),
                       maxs=_tensor(np.asarray(maxs, np.float32), dev))


def kvindex_from_arrays(cfg, channels, bounds, bitmaps,
                        device=None) -> KVIndex:
    """A port ``KVIndex`` on ``device`` (None: the card): ``cfg`` any object
    with the ``KVIndexConfig`` fields, channels (C,) int32, bounds (C, R+1)
    float32, bitmaps (B, H, P, C, W) uint32 (carried as int32 bits)."""
    dev = resolve_device(device)
    cfg = KVIndexConfig(page_size=int(cfg.page_size),
                        num_channels=int(cfg.num_channels),
                        resolution=int(cfg.resolution),
                        keep_buckets=int(cfg.keep_buckets))
    return KVIndex(cfg, _tensor(np.asarray(channels, np.int32), dev),
                   _tensor(np.asarray(bounds, np.float32), dev),
                   _tensor(np.asarray(bitmaps, np.uint32), dev))


def _param(a, dev: torch.device) -> torch.Tensor:
    """A reference parameter array as a tensor: bfloat16 arrays (numpy's
    ml_dtypes bfloat16) cross through float32, which holds them exactly; a
    tensor is moved as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def _tree(node, fn):
    if isinstance(node, dict):
        return {k: _tree(v, fn) for k, v in node.items()}
    return fn(node)


def model_from_reference(cfg, params: dict, device=None) -> Transformer:
    """The port's ``Transformer`` on ``device`` (None: the card) computing
    what the reference computes with ``params``: ``units/b{j}_{kind}`` is
    unstacked along its leading axis into layers ``u*unit_len + j``, then
    ``extra`` follows."""
    dev = resolve_device(device)
    kinds = layer_kinds(cfg)
    blocks = []
    for i, kind in enumerate(kinds[: cfg.num_units * cfg.unit_len]):
        u, j = divmod(i, cfg.unit_len)
        blocks.append(_tree(params["units"][f"b{j}_{kind}"],
                            lambda a, u=u: _param(a[u], dev)))
    for extra in params.get("extra", []):
        blocks.append(_tree(extra, lambda a: _param(a, dev)))
    tree = {k: _tree(v, lambda a: _param(a, dev)) for k, v in params.items()
            if k not in ("units", "extra")}
    tree["blocks"] = blocks
    return Transformer(cfg, tree)


def cache_to_reference(cfg, cache: list[dict]) -> dict:
    """The port's per-layer caches restacked as the reference's
    ``init_cache`` lays them out, as float32 numpy (bfloat16 widened)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    unit_layers = cfg.num_units * cfg.unit_len
    out = {"units": {}}
    for j, kind in enumerate(cfg.block_pattern):
        layers = cache[j:unit_layers:cfg.unit_len]
        out["units"][f"b{j}_{kind}"] = {
            name: np.stack([host(c[name]) for c in layers])
            for name in cache[j]}
    if cfg.leftover_pattern:
        out["extra"] = [{name: host(t) for name, t in c.items()}
                        for c in cache[unit_layers:]]
    return out


def _layer_of(name: str) -> int:
    parts = name.split(".")
    return int(parts[1]) if parts[0] == "blocks" else -1


def _set(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        if key.startswith("["):                     # extra/[e]
            node = node[int(key[1:-1])]
        else:
            node = node.setdefault(key, {})
    node[path[-1]] = value


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of t (never a view of a tensor that training updates in
    place); a meta tensor stays as it is (shapes only)."""
    t = t.detach()
    return t if t.device.type == "meta" else t.to("cpu", copy=True)


def _stack(values: list):
    if isinstance(values[0], dict):                 # an int8 moment
        return {k: _stack([v[k] for v in values]) for k in values[0]}
    out = torch.stack([v.detach() for v in values])        # a new tensor
    return out if out.device.type in ("cpu", "meta") else out.cpu()


def _host(value):
    if isinstance(value, dict):
        return {k: _host(v) for k, v in value.items()}
    return to_host(value)


def tree_to_reference(cfg, named: dict) -> dict:
    """{parameter name: value} (a tensor or an int8 moment's {q, s})
    restacked into the reference's parameter tree as CPU copies (meta
    tensors stay meta):
    ``blocks.i`` of the unit layers stacked over the units into
    ``units/b{j}_{kind}``, the leftover layers as the ``extra`` list."""
    out: dict = {}
    stacked: dict = {}
    n_extra = len(cfg.leftover_pattern)
    if n_extra:
        out["extra"] = [{} for _ in range(n_extra)]
    for name in sorted(named, key=_layer_of):
        path = reference_path(cfg, name)
        if path[0] == "units":
            stacked.setdefault(path, []).append(named[name])
        else:
            _set(out, path, _host(named[name]))
    for path, values in stacked.items():
        _set(out, path, _stack(values))
    return out


def _reference_leaf(cfg, tree: dict, name: str):
    path = reference_path(cfg, name)
    node = tree
    for key in path:
        node = node[int(key[1:-1])] if key.startswith("[") else node[key]
    if path[0] == "units":
        u = _layer_of(name) // cfg.unit_len
        if isinstance(node, dict):
            return {k: v[u] for k, v in node.items()}
        return node[u]
    return node


def _param_names(cfg) -> list[str]:
    return [n for n, _ in init_params(cfg, device="meta").named_parameters()]


def params_to_reference(cfg, model: Transformer) -> dict:
    """The model's parameters as the reference's ``init_params`` tree of CPU
    tensors (the inverse of ``model_from_reference``)."""
    return tree_to_reference(cfg, dict(model.named_parameters()))


def opt_state_to_reference(cfg, state: AdamWState) -> AdamWState:
    """An ``AdamWState`` with the reference's moment trees (CPU tensors)."""
    return AdamWState(step=to_host(state.step),
                      mu=tree_to_reference(cfg, state.mu),
                      nu=tree_to_reference(cfg, state.nu))


def opt_state_from_reference(cfg, state, device=None) -> AdamWState:
    """The port's ``AdamWState`` on ``device`` (None: the card) from a state
    with the reference's fields (step, mu, nu) and moment trees (numpy
    arrays or tensors; any moment dtype)."""
    dev = resolve_device(device)

    def moment(tree, name):
        leaf = _reference_leaf(cfg, tree, name)
        if isinstance(leaf, dict):
            return {k: _param(v, dev) for k, v in leaf.items()}
        return _param(leaf, dev)

    names = _param_names(cfg)
    return AdamWState(
        step=torch.tensor(np.asarray(state.step), dtype=torch.int32,
                          device=dev),
        mu={n: moment(state.mu, n) for n in names},
        nu={n: moment(state.nu, n) for n in names})
