"""Device meshes (port of ``repro.launch.mesh``).

The port has no process group, so a mesh is a small class of its own: an
ndarray of ``torch.device``s with ``axis_names``, ``shape[name]`` and
``size``. Devices may repeat: a mesh of four entries on one card (or on the
CPU, as the tests build 4- and 8-entry meshes) places four blocks on it, as
``--xla_force_host_platform_device_count`` gives the reference virtual
devices. ``with mesh:`` makes a mesh the active one (``current_mesh``).

Builders take ``devices`` (default: every CUDA card, and none raises, by the
port's device rule) and never touch a device when imported.
"""
from __future__ import annotations

import contextvars

import numpy as np
import torch

from repro_torch.device import resolve_device

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                         default=None)


class Mesh:
    """Devices laid out on named axes."""

    def __init__(self, devices: np.ndarray, axis_names: tuple):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self._tokens: list = []

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __enter__(self) -> "Mesh":
        self._tokens.append(_ACTIVE.set(self))
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.reset(self._tokens.pop())


def current_mesh() -> Mesh | None:
    """The mesh of the innermost ``with mesh:``, or None."""
    return _ACTIVE.get()


def _device_list(devices) -> list[torch.device]:
    if devices is None:
        resolve_device(None)                  # raises without CUDA
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh_compat(shape, axes, devices=None) -> Mesh:
    """A mesh of ``shape`` over the first prod(shape) of ``devices``; raises
    when fewer exist, as ``jax.make_mesh`` does."""
    devs = _device_list(devices)
    need = int(np.prod(shape))
    if len(devs) < need:
        raise ValueError(f"mesh {tuple(shape)} needs {need} devices, "
                         f"{len(devs)} available")
    grid = np.empty(need, dtype=object)
    grid[:] = devs[:need]
    return Mesh(grid.reshape(tuple(shape)), tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh_compat(shape, axes, devices)


def make_host_mesh(data: int = 1, model: int = 1, devices=None) -> Mesh:
    """Small mesh over the given or local devices (tests, examples)."""
    return make_mesh_compat((data, model), ("data", "model"), devices)


def make_shard_mesh(num_shards: int, devices=None) -> Mesh:
    """1-D ``data`` mesh for Hippo shard placement (``core.partition``).

    Uses the largest divisor of ``num_shards`` that fits the device count
    (``torch.cuda.device_count()`` by default), so the shard axis always
    divides the mesh: each entry serves a contiguous block of shards; one
    device holds everything.
    """
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    devs = _device_list(devices)
    n = len(devs)
    d = max(k for k in range(1, min(num_shards, n) + 1) if num_shards % k == 0)
    return make_mesh_compat((d,), ("data",), devs)


def batch_axes(mesh: Mesh) -> tuple:
    """Mesh axes a batch dimension shards over (pod+data when present)."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)
