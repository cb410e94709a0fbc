"""Activation batch layout (port of ``repro.models.partition``).

The reference pins the leading activation dim to the mesh's data axes with
``with_sharding_constraint`` whenever the model runs under a mesh context;
outside a mesh it is a no-op. The constraint changes the layout, not the
values. The port runs a model whole on one device, so ``constrain_batch`` is
the identity unless a mesh is active (``with mesh:``, ``launch.mesh.Mesh``):
on a mesh whose positions are all one device (the card, or the CPU in the
tests) it puts x on that device, which holds the whole batch. A mesh that
spans distinct devices is refused where its batch axes divide the batch:
splitting a model's batch over several cards needs a process group, which
the port does not have.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.mesh import current_mesh

# Layout override: e.g. ("pod", "data", "model") for pure-FSDP layouts (batch
# over every axis). None = the default data axes. Read by
# ``launch.shardings._batch_spec_axes`` and here.
BATCH_AXES_OVERRIDE: tuple | None = None


def batch_axes_for(mesh, batch: int) -> tuple:
    """The widest dividing prefix of the batch axes (override or
    ("pod", "data")) for a batch of ``batch`` rows; () if none divides."""
    want = tuple(a for a in (BATCH_AXES_OVERRIDE or ("pod", "data"))
                 if a in mesh.axis_names)
    for k in range(len(want), 0, -1):   # longest dividing prefix wins
        size = int(np.prod([mesh.shape[a] for a in want[:k]]))
        if size and batch % size == 0:
            return want[:k]
    return ()


def constrain_batch(x: torch.Tensor, batch_dim: int = 0) -> torch.Tensor:
    """x as the reference lays it out: unchanged outside a mesh; on the
    device of a mesh whose positions are all that one device; refused on a
    mesh of distinct devices whose batch axes divide x's batch (the
    reference would split it over them there)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    devices = set(mesh.devices.flat)
    if len(devices) == 1:
        return x.to(mesh.devices.flat[0])
    axes = batch_axes_for(mesh, x.shape[batch_dim])
    if not axes:
        return x
    raise NotImplementedError(
        f"the mesh spans {len(devices)} distinct devices; splitting a batch "
        f"of {x.shape[batch_dim]} over mesh axes {axes} needs a process "
        f"group, which the port does not have")
