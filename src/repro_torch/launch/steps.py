"""Prefill / decode step factories and abstract input specs (port of
``repro.launch.steps``).

Shapes come from building on ``torch.device("meta")``, the counterpart of
``jax.eval_shape``: tensors with shapes and dtypes and no allocation. The
train step and the optimizer state come with the training slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import serve, transformer

META = torch.device("meta")


def params_shape(cfg) -> transformer.Transformer:
    """The model's parameters as meta tensors."""
    return transformer.init_params(cfg, device=META)


def cache_shape(cfg, batch: int, max_seq: int) -> list[dict]:
    """``serve.init_cache``'s per-layer caches as meta tensors."""
    return serve.init_cache(cfg, batch, max_seq, device=META)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg, shape, kind: str) -> dict:
    """Meta tensors for one (arch x shape) cell.

    train:   {inputs, labels, positions}
    prefill: {inputs, positions}
    decode:  {tokens, pos}  (cache comes from ``cache_shape``)
    """
    b, s = shape.global_batch, shape.seq_len
    tok = (_spec((b, s), torch.int32) if cfg.frontend == "tokens"
           else _spec((b, s, cfg.d_model), torch.bfloat16))
    pos = _spec((b, s), torch.int32)
    if kind == "train":
        return {"inputs": tok, "labels": _spec((b, s), torch.int32),
                "positions": pos}
    if kind == "prefill":
        return {"inputs": tok, "positions": pos}
    # decode: one new token against a seq_len cache
    tok1 = (_spec((b, 1), torch.int32) if cfg.frontend == "tokens"
            else _spec((b, 1, cfg.d_model), torch.bfloat16))
    return {"tokens": tok1, "pos": _spec((), torch.int32)}


def make_prefill_step(cfg, max_seq: int):
    def prefill_step(model, batch):
        return serve.prefill(model, batch["inputs"], batch["positions"],
                             max_seq)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, cache, tokens, pos):
        return serve.decode_step(model, cache, tokens, pos)
    return decode_step
