"""RWKV-6 ("Finch", arXiv:2404.05892) block (port of ``repro.models.rwkv``):
data-dependent-decay linear attention (time-mix) + channel-mix.

Time-mix recurrence (per head, per step):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with w_t = exp(-exp(wx_t)) a data-dependent per-channel decay and u the
"bonus" for the current token. The state is float32 (B, H, hd, hd); the
data-dependent token-shift mixing runs in the model dtype, as the
reference's. The sequence runs in the reference's time chunks with a
carried (state, shift token); within a chunk, a per-token loop.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

LORA_R = 32
TIME_CHUNK = 128


def rwkv_params_init(cfg, gen, device: torch.device) -> dict:
    dt = layers.dtype_of(cfg.dtype)
    d = cfg.d_model

    def dense(shape, scale=None):
        return layers.dense_init(gen, shape, dt, device, scale=scale)

    return {
        # time-mix projections
        "w_r": dense((d, d)),
        "w_k": dense((d, d)),
        "w_v": dense((d, d)),
        "w_g": dense((d, d)),
        "w_o": dense((d, d)),
        # data-dependent decay (low-rank): wx = w_base + tanh(x A) B
        "decay_base": torch.full((d,), -6.0, device=device),
        "decay_a": dense((d, LORA_R)),
        "decay_b": dense((LORA_R, d), scale=0.1),
        # token-shift interpolation factors (data-dependent mu, low-rank)
        "mu_base": torch.full((5, d), 0.5, device=device),
        "mu_a": dense((d, LORA_R)),
        "mu_b": dense((LORA_R, 5 * d), scale=0.1),
        "bonus": torch.zeros((d,), device=device),
        # channel-mix
        "cm_k": dense((d, cfg.d_ff)),
        "cm_v": dense((cfg.d_ff, d)),
        "cm_r": dense((d, d)),
        "cm_mu": torch.full((2, d), 0.5, device=device),
    }


def _heads(cfg, x: torch.Tensor) -> torch.Tensor:
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    return x.reshape(b, s, d // hd, hd)


def _tmix_chunk(cfg, p, xc: torch.Tensor, prev: torch.Tensor,
                s0: torch.Tensor):
    """One time chunk. xc: (B, L, d); prev: (B, d) last token of the previous
    chunk; s0: (B, H, hd, hd) float32 carry-in state.
    Returns (out (B, L, d), s_last, last_token)."""
    b, l, d = xc.shape
    hd = cfg.resolved_head_dim
    nh = d // hd
    xs = torch.cat([prev[:, None], xc[:, :-1]], dim=1)           # shifted

    # data-dependent interpolation mu_t for the 5 streams (r, k, v, w, g),
    # mixed in the model dtype
    lora = torch.tanh(xc @ p["mu_a"]) @ p["mu_b"]                # (B, L, 5d)
    mu = (p["mu_base"].reshape(1, 1, 5, d)
          + lora.reshape(b, l, 5, d).float()).to(xc.dtype)
    mixed = mu * xc[:, :, None] + (1 - mu) * xs[:, :, None]
    xr, xk, xv, xw, xg = (mixed[:, :, i] for i in range(5))

    r = _heads(cfg, xr @ p["w_r"])                               # (B,L,H,hd)
    k = _heads(cfg, xk @ p["w_k"])
    v = _heads(cfg, xv @ p["w_v"])
    g = F.silu((xg @ p["w_g"]).float())
    wx = p["decay_base"] + (torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
                            ).float()
    w = torch.exp(-torch.exp(wx)).reshape(b, l, nh, hd)          # (0,1)
    u = p["bonus"].reshape(nh, hd)

    r, k, v, w = (t.float() for t in (r, k, v, w))
    state = s0
    outs = []
    for t in range(l):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,hd,hd)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    out = torch.stack(outs, dim=1).reshape(b, l, d)              # float32
    out = (out * g).to(xc.dtype) @ p["w_o"]
    return out, state, xc[:, -1]


def time_mix_apply(cfg, p, x: torch.Tensor, state=None):
    """RWKV6 time-mix. x: (B, S, d). state: {"shift": (B, d),
    "wkv": (B, H, hd, hd)} carry-in (decode/chunked prefill) or None.
    Returns (out, new_state)."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    nh = d // hd
    last = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
            if state is None else state["shift"].to(x.dtype))
    s_last = (torch.zeros((b, nh, hd, hd), dtype=torch.float32,
                          device=x.device)
              if state is None else state["wkv"].float())

    lc = min(TIME_CHUNK, s)
    while s % lc:
        lc -= 1
    outs = []
    for c0 in range(0, s, lc):
        out, s_last, last = _tmix_chunk(cfg, p, x[:, c0:c0 + lc], last,
                                        s_last)
        outs.append(out)
    return torch.cat(outs, dim=1), {"shift": last, "wkv": s_last}


def channel_mix_apply(cfg, p, x: torch.Tensor, state=None):
    """RWKV channel-mix (squared-ReLU FFN with token shift)."""
    if state is None:
        xs = F.pad(x, (0, 0, 1, 0))[:, :-1]
    else:
        xs = state["shift"][:, None, :].to(x.dtype)
    mu = p["cm_mu"].reshape(1, 1, 2, x.shape[-1]).to(x.dtype)
    mr = mu[:, :, 0] * x + (1 - mu[:, :, 0]) * xs
    mk = mu[:, :, 1] * x + (1 - mu[:, :, 1]) * xs
    hidden = torch.square(torch.relu(mk @ p["cm_k"]))
    out = torch.sigmoid((mr @ p["cm_r"]).float()).to(x.dtype) \
        * (hidden @ p["cm_v"])
    return out, {"shift": x[:, -1]}
