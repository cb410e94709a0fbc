"""Checkpoints of the training state with a manifest, async writes and
elastic restore (port of ``repro.checkpointing.checkpoint``).

Layout per step, the reference's:  <dir>/step_<N>/
    manifest.json     — structure fingerprint, leaf shapes/dtypes, step
    leaf_<i>.npy      — one array per leaf (host-gathered)
    COMMITTED         — sentinel written last; restore ignores uncommitted dirs
                        (a crash mid-write can never corrupt the latest state)

Leaves are written in the reference's flatten order of the same state: each
``Transformer`` in the tree is restacked into the reference's parameter tree
and each ``AdamWState`` into its moment trees (``convert``), then dict keys
go in sorted order and lists, tuples and NamedTuples in theirs; so the train
state ``{"params": model, "opt": AdamWState(step, mu, nu)}`` is ``opt``
(step, then ``mu`` and ``nu``) before ``params``, units stacked along axis 0,
an int8 moment's ``q`` before its ``s``. A port checkpoint then holds the
bytes of the reference's checkpoint of the same state: every leaf file, and
the manifest but for its ``treedef`` string, which restore never reads. A
bfloat16 leaf is written as the reference writes it (its raw 2-byte words
under the descr ``<V2``, dtype ``"bfloat16"`` in the manifest) and read back
by the manifest's dtype as ``torch.bfloat16``.

Async mode takes the host copies in the caller's thread and hands them to a
writer thread; training continues (and updates its tensors in place) while
the previous step serializes (write-behind checkpointing).
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpointing.layout import commit_sentinel, fsync_file
from repro_torch.models.transformer import Transformer
from repro_torch.optim.adamw import AdamWState


# ---------------------------------------------------------------------------
# the reference's tree and its flatten order
# ---------------------------------------------------------------------------

def _model_cfg(tree):
    """The config of the first ``Transformer`` in the tree, or None."""
    if isinstance(tree, Transformer):
        return tree.cfg
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)) and not isinstance(tree, AdamWState):
        for v in tree:
            cfg = _model_cfg(v)
            if cfg is not None:
                return cfg
    return None


def _meta(x):
    """A tensor, or a dict of them, as meta tensors (shapes only)."""
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    return x.to("meta")


def _to_reference(node, cfg, meta: bool = False):
    """The reference's tree of ``node`` (CPU copies, or meta tensors for the
    structure only)."""
    if isinstance(node, Transformer):
        named = dict(node.named_parameters())
        return convert.tree_to_reference(node.cfg,
                                         _meta(named) if meta else named)
    if isinstance(node, AdamWState):
        if cfg is None:
            raise ValueError("an AdamWState is saved beside its Transformer")
        return convert.opt_state_to_reference(
            cfg, AdamWState(*map(_meta, node)) if meta else node)
    if isinstance(node, dict):
        return {k: _to_reference(v, cfg, meta) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_to_reference(v, cfg, meta) for v in node))
    if isinstance(node, (list, tuple)):
        return type(node)(_to_reference(v, cfg, meta) for v in node)
    if isinstance(node, torch.Tensor):
        return _meta(node) if meta else convert.to_host(node)
    return node


def _flatten(tree) -> list:
    """Leaves in JAX's order: dict keys sorted, sequences in order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(skeleton, leaves):
    """``skeleton``'s structure with its leaves taken from the iterator."""
    if isinstance(skeleton, dict):
        return {k: _unflatten(skeleton[k], leaves) for k in sorted(skeleton)}
    if isinstance(skeleton, tuple) and hasattr(skeleton, "_fields"):
        return type(skeleton)(*(_unflatten(v, leaves) for v in skeleton))
    if isinstance(skeleton, (list, tuple)):
        return type(skeleton)(_unflatten(v, leaves) for v in skeleton)
    return next(leaves)


# ---------------------------------------------------------------------------
# leaf files
# ---------------------------------------------------------------------------

def _host_leaf(leaf) -> np.ndarray | torch.Tensor:
    """A leaf of the reference's tree (a CPU copy) as a host array: a
    bfloat16 tensor stays a tensor, whose words ``_save_leaf`` writes;
    other tensors become numpy arrays."""
    if isinstance(leaf, torch.Tensor):
        return leaf if leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.asarray(leaf)


def _dtype_name(arr) -> str:
    return "bfloat16" if isinstance(arr, torch.Tensor) else str(arr.dtype)


def _save_leaf(path: Path, arr) -> None:
    if isinstance(arr, torch.Tensor):                      # bfloat16 words
        words = np.ascontiguousarray(arr.contiguous().view(torch.int16)
                                     .numpy())
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, {
                "descr": "<V2", "fortran_order": False,
                "shape": tuple(int(n) for n in words.shape)})
            f.write(words.astype("<i2", copy=False).tobytes())
        return
    np.save(path, arr)


def _load_leaf(path: Path, dtype: str):
    arr = np.load(path)
    if dtype == "bfloat16" and arr.dtype.kind == "V":
        return torch.from_numpy(arr.view("<i2").copy()).view(torch.bfloat16)
    return arr


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------

def save_checkpoint(ckpt_dir: str | Path, step: int, tree, *,
                    async_write: bool = False):
    """Serialize ``tree`` under step_<step>. Returns the writer thread if
    async. The host copies are taken before this returns."""
    ckpt_dir = Path(ckpt_dir)
    ref = _to_reference(tree, _model_cfg(tree))
    host_leaves = [_host_leaf(leaf) for leaf in _flatten(ref)]
    manifest = {
        "step": step,
        # the reference writes its PyTreeDef's string; restore reads neither
        "treedef": f"{len(host_leaves)} leaves in the reference's order",
        "leaves": [{"shape": list(a.shape), "dtype": _dtype_name(a)}
                   for a in host_leaves],
    }

    def write():
        d = ckpt_dir / f"step_{step}"
        if d.exists():
            shutil.rmtree(d)
        d.mkdir(parents=True)
        for i, arr in enumerate(host_leaves):
            _save_leaf(d / f"leaf_{i}.npy", arr)
        (d / "manifest.json").write_text(json.dumps(manifest))
        # Commit point: every payload byte must be durable *before* the
        # sentinel appears, and the sentinel itself lands via an fsynced
        # temp + atomic rename (checkpointing.layout.commit_sentinel).
        for i in range(len(host_leaves)):
            fsync_file(d / f"leaf_{i}.npy")
        fsync_file(d / "manifest.json")
        commit_sentinel(d)

    if async_write:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    return None


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(d.name.split("_")[1]) for d in ckpt_dir.iterdir()
             if d.name.startswith("step_") and (d / "COMMITTED").exists()]
    return max(steps) if steps else None


def _sharding_device(shardings) -> torch.device | None:
    """The one device a sharding (or a tree of them) places on; a mesh of
    distinct devices is refused, since the port runs a model on one."""
    if shardings is None:
        return None
    devices = {d for leaf in _flatten(shardings)
               for d in leaf.mesh.devices.flat}
    if len(devices) != 1:
        raise NotImplementedError(
            f"the shardings span {len(devices)} distinct devices; the port "
            f"restores a state onto one device")
    return devices.pop()


def _rebuild(template, ref, cfg, device):
    """The port's state of ``template``'s form from the reference's tree
    ``ref`` of loaded leaves, on ``device`` (None: each part's own)."""
    if isinstance(template, Transformer):
        return convert.model_from_reference(
            template.cfg, ref, device=device or template.device)
    if isinstance(template, AdamWState):
        return convert.opt_state_from_reference(
            cfg, ref, device=device or template.step.device)
    if isinstance(template, dict):
        return {k: _rebuild(v, ref[k], cfg, device)
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(t, r, cfg, device)
                                for t, r in zip(template, ref)))
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(t, r, cfg, device)
                              for t, r in zip(template, ref))
    if isinstance(template, torch.Tensor):
        t = ref if isinstance(ref, torch.Tensor) else torch.from_numpy(
            np.array(ref))
        return t.to(device or template.device)
    return ref


def restore_checkpoint(ckpt_dir: str | Path, step: int | None = None, *,
                       treedef_like=None, shardings=None):
    """Restore (step, tree). ``treedef_like``: a state with the target
    structure (callers always have the state template — init before
    restore); the restored state is built anew on the template's devices.
    ``shardings``: optional sharding (or tree of them) for placement onto
    the current mesh, whose positions must all be one device."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    if treedef_like is None:
        raise ValueError("pass treedef_like= to reconstruct the tree")
    cfg = _model_cfg(treedef_like)
    skeleton = _to_reference(treedef_like, cfg, meta=True)
    num_leaves = len(_flatten(skeleton))
    if num_leaves != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves; template has "
            f"{num_leaves} — structure mismatch")
    leaves = (_load_leaf(d / f"leaf_{i}.npy", leaf["dtype"])
              for i, leaf in enumerate(manifest["leaves"]))
    ref = _unflatten(skeleton, leaves)
    return manifest["step"], _rebuild(treedef_like, ref, cfg,
                                      _sharding_device(shardings))


class CheckpointManager:
    """Keeps the last ``keep`` committed checkpoints; write-behind async."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3,
                 async_write: bool = True):
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self.async_write = async_write
        self._pending: threading.Thread | None = None

    def save(self, step: int, tree) -> None:
        self.wait()
        self._pending = save_checkpoint(self.dir, step, tree,
                                        async_write=self.async_write)
        if not self.async_write:
            self._gc()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None
            self._gc()

    def restore_latest(self, treedef_like, shardings=None):
        self.wait()
        return restore_checkpoint(self.dir, treedef_like=treedef_like,
                                  shardings=shardings)

    def _gc(self) -> None:
        steps = sorted(int(d.name.split("_")[1]) for d in self.dir.iterdir()
                       if d.name.startswith("step_")
                       and (d / "COMMITTED").exists()) \
            if self.dir.exists() else []
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
