"""End-to-end training CLI (port of ``repro.launch.train``): the
Hippo-indexed data pipeline -> train steps -> checkpoint/restart, under the
fault-tolerant loop.

It runs on the card unless ``--device cpu`` is given; the reduced configs
train on the CPU, the full ones on the card. The flags are the reference's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
      --steps 50 --reduced --batch 8 --seq 64 --ckpt-dir /tmp/ckpt \\
      [--resume] [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpointing import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.predicate import Predicate
from repro_torch.data import HippoDataPipeline, synthesize_corpus
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer
from repro_torch.optim import adamw_init
from repro_torch.runtime.fault import StepWatchdog, resilient_loop


def build_state(cfg, seed: int, device) -> dict:
    """Seeded parameters and zero float32 moments on ``device``."""
    dev = resolve_device(device)
    model = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    return {"params": model, "opt": adamw_init(model)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale config (CPU-friendly)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="simulate preemption: exit after this step (schedule "
                         "still spans --steps, so a resumed run is "
                         "bit-identical to an uninterrupted one)")
    ap.add_argument("--quality-min", type=float, default=0.0,
                    help="Hippo-index data selection predicate lower bound")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises without a card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend != "tokens":
        raise SystemExit("the train CLI expects a token-frontend arch")

    # --- data: Hippo-indexed selection ------------------------------------
    corpus = synthesize_corpus(num_seqs=4096, seq_len=args.seq + 1,
                               vocab_size=cfg.vocab_size, seed=args.seed)
    pipe = HippoDataPipeline.create(
        corpus, Predicate.between(args.quality_min, 1.0), seed=args.seed,
        device=dev)
    print(f"data: {pipe.selected_ids.size}/{corpus.num_seqs} sequences selected "
          f"(inspected {pipe.pages_inspected}/{corpus.table.num_pages} pages "
          f"via Hippo index)")

    # --- state + mesh ---------------------------------------------------------
    mesh = make_host_mesh(data=1, model=1, devices=[dev])
    state = build_state(cfg, args.seed, dev)
    train_step = steps_lib.make_train_step(
        cfg, peak_lr=args.lr, warmup=max(2, args.steps // 10),
        total=args.steps, accum=args.accum)

    mgr = CheckpointManager(args.ckpt_dir, keep=2)
    start = 0
    if args.resume:
        try:
            start, state = mgr.restore_latest(state)
            print(f"resumed from step {start}")
        except FileNotFoundError:
            print("no checkpoint found; starting fresh")

    wd = StepWatchdog()
    losses = []

    def step_fn(step, state):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.get_batch(step, args.batch).items()}
        with mesh:
            model, opt, metrics = train_step(state["params"], state["opt"],
                                             batch)
        losses.append(float(metrics["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}")
        return {"params": model, "opt": opt}

    def save_fn(step, state):
        mgr.save(step, state)

    def restore_fn():
        return mgr.restore_latest(state)

    t0 = time.time()
    stop_at = min(args.steps, args.stop_after) if args.stop_after else args.steps
    state, stats = resilient_loop(
        num_steps=stop_at, step_fn=step_fn, state=state, save_fn=save_fn,
        restore_fn=restore_fn, checkpoint_every=args.ckpt_every, watchdog=wd,
        start_step=start)
    dt = time.time() - t0
    print(f"done: {stats.steps_run} steps in {dt:.1f}s "
          f"({stats.failures} failures, {stats.restores} restores, "
          f"{stats.stragglers} straggler steps)")
    print(f"loss: first {losses[0]:.4f} -> last {losses[-1]:.4f}")
    mgr.wait()
    return losses


if __name__ == "__main__":
    main()
