"""The serving front end (port of ``repro.launch.serve``): batched request
decoding against a prefillable model.

A minimal continuous-batching front: requests arrive with prompts, each is
prefilled alone and merged into a shared cache batch, and the batch decodes
in lock-step; finished requests free their slot for the next queued one.
Two properties of the reference's server are kept for parity:

- ``admit`` merges the new request's cache only into the leaves the
  reference merges, those whose axis 1 is the batch in its layout: every
  unit layer's (stacked there as (num_units, B, ...)); a leftover layer's
  (B, ...) leaves are written along axis 1 only when that axis happens to
  equal the batch, and otherwise keep their old state.
- ``step`` decodes every slot at the largest slot position.

Usage (on the card by default; ``--device cpu`` runs on the CPU):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
      --reduced --device cpu --requests 6 --batch 4 --prompt-len 16 --gen 24
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import serve, transformer


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    generated: list = field(default_factory=list)
    done: bool = False


class BatchServer:
    """Lock-step batched decoder with slot recycling."""

    def __init__(self, model: transformer.Transformer, batch: int,
                 max_seq: int):
        self.model, self.cfg = model, model.cfg
        self.batch, self.max_seq = batch, max_seq
        self.device = model.device
        self.cache = serve.init_cache(self.cfg, batch, max_seq, self.device)
        self.pos = np.zeros(batch, np.int64)
        self.slots: list[Request | None] = [None] * batch

    def _merge(self, i: int, cache1: list[dict]) -> None:
        unit_layers = self.cfg.num_units * self.cfg.unit_len
        for layer, (full, one) in enumerate(zip(self.cache, cache1)):
            for name, leaf in full.items():
                if layer < unit_layers:
                    leaf[i] = one[name][0]
                elif leaf.ndim >= 2 and leaf.shape[1] == self.batch:
                    leaf[:, i] = one[name][:, 0]

    def admit(self, req: Request) -> bool:
        for i, s in enumerate(self.slots):
            if s is None:
                # prefill the slot (single-request prefill, then merge cache)
                prompt = torch.as_tensor(req.prompt[None, :],
                                         device=self.device)
                positions = torch.arange(prompt.shape[1],
                                         device=self.device)[None, :]
                logits, cache1 = serve.prefill(self.model, prompt, positions,
                                               self.max_seq)
                self._merge(i, cache1)
                req.generated.append(int(torch.argmax(logits[0])))
                self.slots[i] = req
                self.pos[i] = prompt.shape[1]
                return True
        return False

    def step(self) -> None:
        """One lock-step decode for all active slots."""
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return
        tokens = np.zeros((self.batch, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].generated[-1]
        # lock-step uses the max position; per-slot masks come from cache state
        pos = int(max(self.pos[i] for i in active))
        logits, self.cache = serve.decode_step(
            self.model, self.cache, torch.as_tensor(tokens, device=self.device),
            pos)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        for i in active:
            self.slots[i].generated.append(int(nxt[i]))
            self.pos[i] += 1

    def retire(self, max_gen: int) -> list[Request]:
        out = []
        for i, s in enumerate(self.slots):
            if s is not None and len(s.generated) >= max_gen:
                s.done = True
                out.append(s)
                self.slots[i] = None
        return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; cuda raises without a card")
    ap.add_argument("--dtype", default=None,
                    help="model dtype (default: the config's)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.dtype:
        cfg = replace(cfg, dtype=args.dtype)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = transformer.init_params(cfg, gen, dev)
    rng = np.random.default_rng(args.seed)
    queue = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                args.prompt_len).astype(np.int32))
             for i in range(args.requests)]
    server = BatchServer(model, args.batch,
                         max_seq=args.prompt_len + args.gen + 1)

    finished: list[Request] = []
    t0 = time.time()
    steps = 0
    while len(finished) < args.requests:
        while queue and server.admit(queue[0]):
            print(f"admitted request {queue[0].rid}")
            queue.pop(0)
        server.step()
        steps += 1
        finished.extend(server.retire(args.gen))
    dt = time.time() - t0
    tok = sum(len(r.generated) for r in finished)
    print(f"served {len(finished)} requests / {tok} tokens in {dt:.2f}s "
          f"({steps} decode steps, {tok/dt:.1f} tok/s) on {dev}")
    for r in finished[:3]:
        print(f"  req {r.rid}: {r.generated[:8]}...")
    return finished


if __name__ == "__main__":
    main()
