"""End-to-end training example: train a ~100M-class model (reduced
smollm family) for a few hundred steps through the full stack —
Hippo-indexed data selection, AdamW, checkpointing, fault-tolerant loop
(port of ``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300] \\
        [--ckpt-dir DIR] [--device cpu]

The same ``launch/train.py`` code path that trains the full configs runs
here, on the card unless ``--device cpu`` is given. Checkpoints go to
``--ckpt-dir`` (default: ``repro_torch_example_ckpt`` in the temporary
directory).
"""
import argparse
import os
import tempfile

from repro_torch.device import resolve_device
from repro_torch.launch import train as train_cli


def train_argv(steps: int, arch: str, ckpt_dir: str) -> list:
    """The train CLI's arguments for this example, without ``--device``."""
    return ["--arch", arch, "--reduced",
            "--steps", str(steps),
            "--batch", "16", "--seq", "64",
            "--lr", "3e-3",
            "--quality-min", "0.5",          # Hippo-index data selection predicate
            "--ckpt-dir", ckpt_dir,
            "--ckpt-every", "50"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_example_ckpt"))
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises without a card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    losses = train_cli.main(train_argv(args.steps, args.arch, args.ckpt_dir)
                               + ["--device", str(dev)])
    assert losses[-1] < losses[0], "loss must decrease"
    print(f"\nOK: loss {losses[0]:.3f} -> {losses[-1]:.3f} over {args.steps} steps")


if __name__ == "__main__":
    main()
