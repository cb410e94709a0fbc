"""Train / prefill / decode step factories and abstract input specs (port
of ``repro.launch.steps``).

Shapes come from building on ``torch.device("meta")``, the counterpart of
``jax.eval_shape``: tensors with shapes and dtypes and no allocation. The
train step takes gradients with autograd; its gradient accumulation is a
loop over microbatches where the reference scans them.
"""
from __future__ import annotations

import torch

from repro_torch.models import serve, transformer
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw_init, adamw_update, warmup_cosine
from repro_torch.optim.adamw import AdamWState

META = torch.device("meta")


def params_shape(cfg) -> transformer.Transformer:
    """The model's parameters as meta tensors."""
    return transformer.init_params(cfg, device=META)


def opt_state_shape(cfg, p_shape, moment_dtype: str = "float32"
                    ) -> AdamWState:
    """``adamw_init`` of a meta ``Transformer`` (``params_shape``): the
    optimizer state's shapes and dtypes with no allocation."""
    return adamw_init(p_shape, moment_dtype)


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


def make_train_step(cfg, *, peak_lr: float = 3e-4, warmup: int = 2000,
                    total: int = 100_000, weight_decay: float = 0.1,
                    remat: bool = True, accum: int = 1,
                    accum_dtype: str = "float32", opt_unit_scan: bool = False):
    """(model, opt_state, batch) -> (model, opt_state, metrics), with
    ``metrics`` holding ``loss`` and ``grad_norm``; the model's parameters
    are updated in place (and get ``requires_grad``: training only).

    ``accum`` > 1 splits the batch into microbatches and accumulates their
    gradients in ``accum_dtype``: activation memory scales with
    batch/accum while the arithmetic is unchanged.
    """
    adt = dtype_of(accum_dtype)

    def grads_of(model, batch):
        named = dict(model.named_parameters())
        loss = transformer.loss_fn(model, batch, remat=remat)
        grads = torch.autograd.grad(loss, list(named.values()),
                                    allow_unused=True)
        return loss.detach(), {
            n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(named.items(), grads)}

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        lr = warmup_cosine(opt_state.step, peak_lr=peak_lr,
                           warmup_steps=warmup, total_steps=total)
        if accum == 1:
            loss, grads = grads_of(model, batch)
        else:
            micro = {k: t.reshape(accum, t.shape[0] // accum, *t.shape[1:])
                     for k, t in batch.items()}
            tot = torch.zeros((), dtype=torch.float32, device=model.device)
            grads = {n: torch.zeros(p.shape, dtype=adt, device=p.device)
                     for n, p in model.named_parameters()}
            for i in range(accum):
                loss, g = grads_of(model, {k: t[i] for k, t in micro.items()})
                grads = {n: (a.to(torch.float32) + g[n].to(torch.float32)
                             ).to(adt) for n, a in grads.items()}
                tot = tot + loss
            loss = tot / accum
            grads = {n: g / accum for n, g in grads.items()}
        model, opt_state, metrics = adamw_update(
            grads, opt_state, model, lr=lr, weight_decay=weight_decay,
            unit_scan=opt_unit_scan)
        metrics["loss"] = loss
        return model, opt_state, metrics

    return train_step


def make_prefill_step(cfg, max_seq: int):
    def prefill_step(model, batch):
        return serve.prefill(model, batch["inputs"], batch["positions"],
                             max_seq)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, cache, tokens, pos):
        return serve.decode_step(model, cache, tokens, pos)
    return decode_step
