"""AdamW with a configurable moment dtype and global-norm clipping (port of
``repro.optim.adamw``).

The state is ``AdamWState(step, mu, nu)``: ``step`` an int32 scalar, ``mu``
and ``nu`` dicts keyed like the ``Transformer``'s named parameters
(``model.named_parameters()``). A moment is a tensor of ``moment_dtype``
(float32 or bfloat16) or, for ``"int8"``, ``{"q": int8, "s": float32
(..., 1)}``: row-quantized with a max-abs scale per trailing-dim row
(8-bit-Adam style, 4x smaller than float32). The update math runs in float32
and casts back to the parameter's and the moment's dtype; quantization error
is storage only. ``convert.opt_state_to_reference`` restacks a state into the
reference's tree.

Gradient accumulation lives in the train step (``launch.steps``) and
composes with this update unchanged.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.models.layers import dtype_of


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict


def q8_encode(x32: torch.Tensor) -> dict:
    """Row-quantize float32 to {q: int8, s: float32 (..., 1)} (symmetric
    max-abs)."""
    amax = x32.abs().amax(dim=-1, keepdim=True)
    s = torch.clamp(amax / 127.0, min=1e-20)
    q = torch.clamp(torch.round(x32 / s), -127, 127).to(torch.int8)
    return {"q": q, "s": s.to(torch.float32)}


def q8_decode(d: dict) -> torch.Tensor:
    return d["q"].to(torch.float32) * d["s"]


def _is_q8(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "s"}


def adamw_init(params: nn.Module, moment_dtype: str = "float32"
               ) -> AdamWState:
    """Zero moments for a ``Transformer``'s parameters, on each parameter's
    device (the meta device gives shapes only)."""
    named = dict(params.named_parameters())
    if moment_dtype == "int8":
        def zeros(p):
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.zeros((*p.shape[:-1], 1), dtype=torch.float32,
                                     device=p.device)}
    else:
        dt = dtype_of(moment_dtype)

        def zeros(p):
            return torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = next(iter(named.values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu={n: zeros(p) for n, p in named.items()},
                      nu={n: zeros(p) for n, p in named.items()})


def clip_by_global_norm(grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    """Gradients scaled so that their global float32 norm is at most
    ``max_norm`` (each cast back to its dtype), and that norm. The squares
    are summed in the dict's order."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return ({n: (g.to(torch.float32) * scale).to(g.dtype)
             for n, g in grads.items()}, gn)


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: nn.Module, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                 unit_scan: bool = False):
    """One AdamW step. ``lr`` may be a float or a float32 scalar tensor.

    ``params`` is a ``Transformer``; the new values are written into its
    parameters in place (``copy_``), so the module's parameters stay the
    optimizer's. ``unit_scan`` is the reference's switch
    to update its stacked units one at a time so that the float32 transients
    are bounded by one unit; the port updates one parameter at a time, so its
    transients are bounded by one leaf with or without it.

    Returns (params, new_state, metrics).
    """
    del unit_scan
    named = dict(params.named_parameters())
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    stepf = step.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                      device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                      device=stepf.device), stepf)
    lr = torch.as_tensor(lr, dtype=torch.float32, device=stepf.device)
    mu, nu = {}, {}
    for name, p in named.items():
        g32 = grads[name].to(torch.float32)
        m, v = state.mu[name], state.nu[name]
        quant = _is_q8(m)
        m32 = q8_decode(m) if quant else m.to(torch.float32)
        v32 = q8_decode(v) if quant else v.to(torch.float32)
        m32 = b1 * m32 + (1 - b1) * g32
        v32 = b2 * v32 + (1 - b2) * g32 * g32
        mhat = m32 / c1
        vhat = v32 / c2
        p32 = p.to(torch.float32)
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
        if quant:
            mu[name], nu[name] = q8_encode(m32), q8_encode(v32)
        else:
            mu[name], nu[name] = m32.to(m.dtype), v32.to(v.dtype)
    return params, AdamWState(step, mu, nu), {"grad_norm": gnorm}
