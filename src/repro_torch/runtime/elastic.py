"""Elastic scaling (port of ``repro.runtime.elastic``): re-place a
host-resident tree of arrays onto a new mesh.

Growing or shrinking is: build the new mesh, recompute the specs
(``launch.shardings`` is mesh-shape-agnostic), place every leaf. A spec that
does not divide its leaf falls back to replication rather than failing.
A training checkpoint is restored onto one device by
``checkpointing.checkpoint.restore_checkpoint``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.launch.shardings import P, NamedSharding, place


def validate_divisibility(shape: tuple, spec: P, mesh: Mesh) -> bool:
    for dim, axes in zip(shape, spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        total = int(np.prod([mesh.shape[a] for a in axes]))
        if dim % total:
            return False
    return True


def _place_leaf(leaf, spec: P, mesh: Mesh):
    t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
        np.asarray(leaf))
    if not validate_divisibility(tuple(t.shape), spec, mesh):
        spec = P()  # fall back to replication rather than failing restore
    return place(t, NamedSharding(mesh, spec))


def reshard_for_mesh(tree, specs, mesh: Mesh):
    """Place every leaf of ``tree`` (nested dicts, lists and tuples of arrays
    or tensors) with its spec on ``mesh``; ``specs`` is a matching tree of
    ``P`` or one ``P`` for every leaf."""
    if isinstance(tree, dict):
        return {k: reshard_for_mesh(v, specs if isinstance(specs, P)
                                    else specs[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reshard_for_mesh(v, specs if isinstance(specs, P)
                                           else specs[i], mesh)
                          for i, v in enumerate(tree))
    return _place_leaf(tree, specs, mesh)
