"""Multi-pod dry run: price every (arch x shape x mesh) cell's per-device
memory (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 forced XLA host devices
and records XLA's ``memory_analysis``, ``cost_analysis`` and the HLO's
collectives. The port compiles no program. For each cell it:
  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod) over
     256 or 512 repeats of ``torch.device("meta")``, the counterpart of the
     reference's forced host devices, so that nothing is allocated;
  2. takes the step's arguments as meta tensors (train: parameters,
     optimizer state and batch; prefill: parameters, ``inputs`` and
     ``positions``; decode: parameters, cache, tokens and the int32 ``pos``)
     and its returned trees, each under the reference's shardings (the
     port's spec rules, ``launch.shardings``);
  3. sums, per leaf, the bytes of the block that mesh position 0 holds
     (``shardings._fit`` and ``block_slices``): a dimension split over axes
     (a, b) splits into size(a)*size(b) blocks;
  4. writes one JSON record per cell with every key of the reference's
     record, in the same nesting.

``memory.argument_bytes_per_device`` equals XLA's
``memory_analysis().argument_size_in_bytes`` for the reference's compiled
cell: XLA's per-device arguments are the sums of the shard shapes, and the
port's per-layer leaves sum to the reference's stacked ones, since the unit
axis is never sharded. ``memory.output_bytes_per_device`` is the same sum
over the step's returned trees under the reference's ``out_shardings``; the
outputs it leaves to XLA take the layout XLA gives them (the train step's
``loss`` and ``grad_norm`` replicated; the logits (B, V) with B over the
batch axes and V over ``model``, in the head's dtype). XLA's
``output_size_in_bytes`` counts 8 B more per leaf of the output tuple (its
table of buffer pointers), which the port does not: 312 B on the reduced
yi-6b train cell (39 leaves).

Keys that have no counterpart hold null and are listed in the record's
``no_counterpart``: there is no HLO, so no compile time, temporaries,
generated code or collectives, and no compile-time cost analysis; the
reference's ``tpu_total_bytes_est`` and ``fits_hbm_16gib`` are its
statement about a TPU. ``parse_collectives`` is not ported, since nothing
in the port produces HLO text. For the card the record adds ``hbm_bytes``
and ``arguments_fit_hbm`` (the arguments' block bytes below the card's
memory): a necessary condition for the cell to run on one card, not a
sufficient one, since the step's temporaries are unknown.

The reference leaves ``models.partition.BATCH_AXES_OVERRIDE`` set after
each cell; the port sets it for the cell and restores the caller's value.
Importing this module sets no environment variable.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
      [--mesh single|multi|both] [--out artifacts/dryrun] [--hbm-bytes N]
"""
from __future__ import annotations

import argparse
import json
import math
import traceback
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.configs import get_config, list_archs, shape_cells
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardings import (
    P, NamedSharding, _batch_spec_axes, _fit, block_slices,
    make_opt_shardings, make_param_shardings, replicated,
    train_batch_shardings, tree_cache_shardings,
)
from repro_torch.models import partition, transformer

META = steps_lib.META

# Keys of the reference's record that hold null here (dotted for nesting).
NO_COUNTERPART = (
    "compile_s", "memory.temp_bytes_per_device", "memory.code_bytes",
    "memory.tpu_total_bytes_est", "memory.total_bytes_per_device",
    "cost_analysis.flops_per_device",
    "cost_analysis.bytes_accessed_per_device", "collectives",
    "fits_hbm_16gib",
)


@dataclass(frozen=True)
class CellPlan:
    """How the reference lays out and steps one cell."""
    fsdp_only: bool
    n_dev_batch: int
    accum: int
    moment_dtype: str
    accum_dtype: str


def cell_plan(cfg, shape, multi_pod: bool) -> CellPlan:
    """The reference's layout, accumulation and optimizer dtypes for a
    cell (``src/repro/launch/dryrun.py:87-115``)."""
    big = "400b" in cfg.name
    # bf16 moments and accumulation for the 400B cell: the reference found
    # int8 moments worse (src/repro/launch/dryrun.py:88, :127-129)
    moment_dtype = "bfloat16" if big else "float32"
    accum_dtype = "bfloat16" if big else "float32"
    # Non-MoE, non-hybrid TRAIN cells are FSDP-only: the batch shards over
    # (pod, data, model) jointly and weights are gathered per use instead of
    # blocking TP all-reduces. MoE archs keep TP/EP (a gathered MoE unit
    # would not fit); hybrid (Griffin) keeps TP, its d^2-heavy recurrent
    # units make gathered-weight working sets dominate; decode and prefill
    # keep TP, their batch is too small to shard 256/512 ways
    # (src/repro/launch/dryrun.py:90-101).
    fsdp_only = (shape.kind == "train" and cfg.num_experts == 0
                 and cfg.family != "hybrid")
    # gradient accumulation keeps the activation working set at ~4
    # sequences a device (1 for the 400B cell)
    n_dev_batch = 32 if multi_pod else 16
    if multi_pod and cfg.name == "qwen2-moe-a2.7b":
        n_dev_batch = 16   # accum 4 (src/repro/launch/dryrun.py:107-108)
    if fsdp_only:
        # the batch shards over the widest dividing prefix of (pod, data,
        # model): 256 ways single-pod (1 sequence a device), 32 ways
        # multi-pod (pod, data)
        n_dev_batch = 32 if multi_pod else 256
    per_dev_seqs = 1 if big else 4
    accum = (max(1, shape.global_batch // (n_dev_batch * per_dev_seqs))
             if shape.kind == "train" else 1)
    return CellPlan(fsdp_only, n_dev_batch, accum, moment_dtype, accum_dtype)


def _leaves(tree, shardings):
    """(leaf, sharding) pairs of a tree of tensors and its shardings (dicts,
    lists and tuples, ``AdamWState`` included)."""
    if isinstance(tree, torch.Tensor):
        yield tree, shardings
    elif isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], shardings[k])
    else:
        for t, s in zip(tree, shardings, strict=True):
            yield from _leaves(t, s)


def block_shape(leaf: torch.Tensor, sharding: NamedSharding) -> tuple:
    """The shape of the block mesh position 0 holds of ``leaf``."""
    mesh = sharding.mesh
    sl = block_slices(mesh, sharding.spec, tuple(leaf.shape),
                      (0,) * mesh.devices.ndim)
    return tuple(s.stop - s.start for s in sl)


def _scalar(dtype: torch.dtype) -> torch.Tensor:
    return torch.empty((), dtype=dtype, device=META)


def cell_blocks(cfg, shape, multi_pod: bool, *, params=None
                ) -> tuple[CellPlan, list, list]:
    """(plan, argument blocks, output blocks) of one cell on the production
    mesh over meta devices: each block a (shape, dtype) that mesh position 0
    holds of one leaf of the step's arguments or returned trees. ``params``
    is ``steps.params_shape(cfg)`` where the caller has it."""
    plan = cell_plan(cfg, shape, multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod,
                                devices=[META] * (512 if multi_pod else 256))
    p_shape = steps_lib.params_shape(cfg) if params is None else params
    params_tree = dict(p_shape.named_parameters())
    b = shape.global_batch
    before = partition.BATCH_AXES_OVERRIDE
    partition.BATCH_AXES_OVERRIDE = (("pod", "data", "model")
                                     if plan.fsdp_only else None)
    try:
        p_sh = make_param_shardings(cfg, mesh, p_shape)
        specs = steps_lib.input_specs(cfg, shape, shape.kind)
        b_sh = train_batch_shardings(cfg, mesh, b)
        if shape.kind == "train":
            o_shape = steps_lib.opt_state_shape(cfg, p_shape,
                                                plan.moment_dtype)
            o_sh = make_opt_shardings(cfg, mesh, o_shape)
            metrics = {"grad_norm": _scalar(torch.float32),
                       "loss": _scalar(torch.float32)}
            m_sh = {k: replicated(mesh) for k in metrics}
            args = [(params_tree, p_sh), (o_shape, o_sh), (specs, b_sh)]
            outs = [(params_tree, p_sh), (o_shape, o_sh), (metrics, m_sh)]
        else:
            c_shape = steps_lib.cache_shape(cfg, b, shape.seq_len)
            c_sh = tree_cache_shardings(cfg, mesh, c_shape, b)
            head = transformer.lm_head(p_shape)
            logits = torch.empty((b, head.shape[-1]), dtype=head.dtype,
                                 device=META)
            l_sh = NamedSharding(mesh, _fit(mesh, P(_batch_spec_axes(
                mesh, b), "model"), tuple(logits.shape)))
            outs = [(logits, l_sh), (c_shape, c_sh)]
            if shape.kind == "prefill":
                args = [(params_tree, p_sh),
                        ({k: specs[k] for k in ("inputs", "positions")},
                         {k: b_sh[k] for k in ("inputs", "positions")})]
            else:
                args = [(params_tree, p_sh), (c_shape, c_sh),
                        (specs["tokens"], b_sh["inputs"]),
                        (specs["pos"], replicated(mesh))]
        blocks = [[(block_shape(leaf, sh), leaf.dtype)
                   for tree, shs in part for leaf, sh in _leaves(tree, shs)]
                  for part in (args, outs)]
    finally:
        partition.BATCH_AXES_OVERRIDE = before
    return plan, blocks[0], blocks[1]


def blocks_bytes(blocks: list) -> int:
    return sum(math.prod(s) * d.itemsize for s, d in blocks)


def lower_cell(arch: str, shape_name: str, multi_pod: bool, *,
               hbm_bytes: int | None = None, params=None) -> dict:
    """Price one cell; returns the JSON record. ``hbm_bytes`` is the card's
    memory (None: ``total_memory`` of the card, which must exist);
    ``params`` as for ``cell_blocks``."""
    if hbm_bytes is None:
        hbm_bytes = torch.cuda.get_device_properties(
            resolve_device(None)).total_memory
    cfg = get_config(arch)
    shape = next(s for s in shape_cells(cfg) if s.name == shape_name)
    plan, args, outs = cell_blocks(cfg, shape, multi_pod, params=params)
    arg_bytes = blocks_bytes(args)
    return {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "devices": 512 if multi_pod else 256,
        "grad_accum": plan.accum,
        "layout": "fsdp_only" if plan.fsdp_only else "tp",
        "compile_s": None,
        "memory": {
            "argument_bytes_per_device": arg_bytes,
            "output_bytes_per_device": blocks_bytes(outs),
            "temp_bytes_per_device": None,
            "code_bytes": None,
            "tpu_total_bytes_est": None,
            "total_bytes_per_device": None,
        },
        "cost_analysis": {"flops_per_device": None,
                          "bytes_accessed_per_device": None},
        "collectives": None,
        "fits_hbm_16gib": None,
        "hbm_bytes": int(hbm_bytes),
        "arguments_fit_hbm": bool(arg_bytes < hbm_bytes),
        "no_counterpart": list(NO_COUNTERPART),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="device memory to hold the arguments against "
                         "(default: the card's)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else list_archs()
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    hbm = args.hbm_bytes
    if hbm is None:
        hbm = torch.cuda.get_device_properties(
            resolve_device(None)).total_memory

    failures = []
    for arch in archs:
        cfg = get_config(arch)
        p_shape = steps_lib.params_shape(cfg)
        for shape in shape_cells(cfg):
            if args.shape and shape.name != args.shape:
                continue
            for multi in meshes:
                tag = f"{arch}_{shape.name}_{'multi' if multi else 'single'}"
                path = out_dir / f"{tag}.json"
                try:
                    rec = lower_cell(arch, shape.name, multi, hbm_bytes=hbm,
                                     params=p_shape)
                    path.write_text(json.dumps(rec, indent=1))
                    mem = rec["memory"]
                    print(f"OK   {tag}  "
                          f"args/dev={mem['argument_bytes_per_device'] / 2**30:.2f}GiB  "
                          f"fits={rec['arguments_fit_hbm']}")
                except Exception as e:  # noqa: BLE001
                    failures.append(tag)
                    print(f"FAIL {tag}: {e}")
                    traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILED: {failures}")
        raise SystemExit(1)
    print("\nall cells priced")


if __name__ == "__main__":
    main()
