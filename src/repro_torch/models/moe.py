"""Mixture-of-Experts FFN with capacity-based *slot-indexed* dispatch (port of
``repro.models.moe``).

Tokens are grouped per batch row: capacity is computed within each group,
routing state is (S, K) slots and gates per group. Router: softmax (qwen) or
sigmoid (llama4) over expert logits in float32, top-k (ties to the lower
expert index, as ``jax.lax.top_k``: a stable descending sort guarantees it on
every device), gates renormalized for softmax with k > 1. An assignment's
position within its expert is a running count over the flattened (token, k)
order; assignments at or past capacity go to slot ``E*C``, which the
dispatch buffer holds as one spare row: scattered there and discarded
(the reference's ``mode="drop"``), gathered from there as zeros
(``mode="fill"``). Shared experts are a plain SwiGLU over every token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def moe_params_init(cfg, gen, device: torch.device) -> dict:
    dt = layers.dtype_of(cfg.dtype)
    f = cfg.moe_d_ff or cfg.d_ff
    e = cfg.num_experts
    p = {
        "router": layers.dense_init(gen, (cfg.d_model, e), torch.float32,
                                    device),
        "w_gate": layers.dense_init(gen, (e, cfg.d_model, f), dt, device),
        "w_up": layers.dense_init(gen, (e, cfg.d_model, f), dt, device),
        "w_down": layers.dense_init(gen, (e, f, cfg.d_model), dt, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = layers.ffn_params_init(
            cfg, gen, device, d_ff=cfg.num_shared_experts * f)
    return p


def group_capacity(cfg, group_tokens: int) -> int:
    cap = int(math.ceil(cfg.capacity_factor * group_tokens * cfg.top_k
                        / max(cfg.num_experts, 1)))
    return max(cap, 1)


def _route(cfg, xf: torch.Tensor, router: torch.Tensor):
    """xf: (..., S, d), one group per leading index. Returns (slot, gate),
    each (..., S, K), with slot = expert*C + position_in_expert for kept
    assignments and E*C for capacity-dropped ones (whose gate is 0)."""
    s = xf.shape[-2]
    e, k = cfg.num_experts, cfg.top_k
    c = group_capacity(cfg, s)
    logits = xf.float() @ router
    if cfg.router_act == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        probs = layers.softmax(logits)
    gate, expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = gate[..., :k], expert_idx[..., :k]         # (..., S, K)
    if cfg.router_act == "softmax" and k > 1:
        gate = gate / (gate.sum(dim=-1, keepdim=True) + 1e-9)
    lead = expert_idx.shape[:-2]
    onehot = F.one_hot(expert_idx.reshape(*lead, s * k), e).to(torch.int32)
    pos = (torch.cumsum(onehot, dim=-2) * onehot).sum(dim=-1) - 1  # (..., S*K)
    pos = pos.reshape(*lead, s, k)
    keep = pos < c
    slot = torch.where(keep, expert_idx * c + pos, e * c)
    return slot, gate * keep


def moe_apply(cfg, p, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). Routed top-k experts + shared experts."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    c = group_capacity(cfg, s)

    slot, gate = _route(cfg, x, p["router"])                     # (B, S, K)
    idx = slot.reshape(b, s * k, 1).expand(b, s * k, d)
    # dispatch: scatter tokens into (B, E*C + 1, d) slot buffers; the spare
    # row takes the dropped assignments and is discarded
    tok = x.repeat_interleave(k, dim=1)                           # (B, S*K, d)
    buf = torch.zeros((b, e * c + 1, d), dtype=x.dtype, device=x.device)
    buf.scatter_add_(1, idx, tok)
    exp_in = buf[:, : e * c].reshape(b, e, c, d)

    hidden = F.silu(torch.einsum("becd,edf->becf", exp_in, p["w_gate"]))
    hidden = hidden * torch.einsum("becd,edf->becf", exp_in, p["w_up"])
    exp_out = torch.einsum("becf,efd->becd", hidden, p["w_down"])  # (B,E,C,d)

    # combine: gather each assignment's slot output (the spare row reads as
    # zero), weight by the gate
    flat = torch.cat([exp_out.reshape(b, e * c, d),
                      torch.zeros((b, 1, d), dtype=exp_out.dtype,
                                  device=x.device)], dim=1)
    picked = flat.gather(1, idx).reshape(b, s, k, d)
    out = (picked * gate[..., None].to(picked.dtype)).sum(dim=2)

    if cfg.num_shared_experts:
        out = out + layers.ffn_apply(p["shared"],
                                     x.reshape(b * s, d)).reshape(b, s, d)
    return out


def aux_load_balance_loss(cfg, x: torch.Tensor, p) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss."""
    n = x.shape[0] * x.shape[1]
    logits = x.reshape(n, -1).float() @ p["router"]
    probs = layers.softmax(logits)
    top1 = torch.argmax(probs, dim=-1)
    frac_tokens = F.one_hot(top1, cfg.num_experts).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    return cfg.num_experts * torch.sum(frac_tokens * frac_probs)
