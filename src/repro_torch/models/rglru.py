"""Griffin/RecurrentGemma recurrent block: temporal conv + RG-LRU (port of
``repro.models.rglru``).

RG-LRU (arXiv:2402.19427 §2.4):
    r_t = sigmoid(x_t W_r)                     recurrence gate
    i_t = sigmoid(x_t W_i)                     input gate
    a_t = exp(-c * softplus(Lambda) * r_t)     data-dependent decay in (0,1)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference runs the affine recurrence within a time chunk as an
``associative_scan``; here it is a sequential float32 loop over the chunk's
steps, which computes the same values up to rounding. Chunks follow the
reference's ``TIME_CHUNK`` and carry (conv window, h).

Block layout (Griffin): y = W_out( GeLU(x W_gate) * RG-LRU(conv1d(x W_x)) ),
with the tanh GeLU (``jax.nn.gelu``'s default). The same path serves decode
(S=1, carried state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers

TIME_CHUNK = 256


def rglru_params_init(cfg, gen, device: torch.device) -> dict:
    dt = layers.dtype_of(cfg.dtype)
    d = cfg.d_model
    return {
        "w_x": layers.dense_init(gen, (d, d), dt, device),
        "w_gate": layers.dense_init(gen, (d, d), dt, device),
        "w_out": layers.dense_init(gen, (d, d), dt, device),
        # depthwise causal temporal conv, width cfg.conv_width; tap 0 applies
        # to the newest timestep
        "conv": layers.dense_init(gen, (cfg.conv_width, d), dt, device,
                                  scale=0.5),
        "w_r": layers.dense_init(gen, (d, d), dt, device),
        "w_i": layers.dense_init(gen, (d, d), dt, device),
        # Lambda init so softplus(Lambda) spans decay half-lives ~ [3, 700]
        "lam": torch.linspace(-2.0, 2.0, d, dtype=torch.float32,
                              device=device),
    }


def _conv_with_tail(u: torch.Tensor, tail: torch.Tensor, w: torch.Tensor):
    """Causal depthwise conv over a chunk given the previous K-1 inputs.

    u: (B, L, d); tail: (B, K-1, d); w: (K, d) with w[0] on the newest step.
    Returns (uc (B, L, d), new_tail (B, K-1, d))."""
    k = w.shape[0]
    ext = torch.cat([tail, u], dim=1)                 # (B, L+K-1, d)
    out = torch.zeros_like(u)
    for j in range(k):
        out = out + ext[:, k - 1 - j: ext.shape[1] - j, :] * w[j][None, None, :]
    return out, ext[:, -(k - 1):, :]


def _chunk_core(cfg, p, xc: torch.Tensor, tail: torch.Tensor,
                h0: torch.Tensor):
    """One time chunk of the recurrent branch. xc: (B, L, d) block input
    (post-norm); tail: (B, K-1, d) conv carry; h0: (B, d) hidden carry.
    Returns (h (B, L, d), new_tail, h_last)."""
    u = xc @ p["w_x"]
    uc, new_tail = _conv_with_tail(u, tail, p["conv"])
    r = torch.sigmoid((uc @ p["w_r"]).float())
    i = torch.sigmoid((uc @ p["w_i"]).float())
    log_a = -cfg.rglru_c * F.softplus(p["lam"])[None, None, :] * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uc.float())
    h = h0.float()
    hs = []
    for t in range(xc.shape[1]):
        h = torch.addcmul(gated[:, t], a[:, t], h)
        hs.append(h)
    h = torch.stack(hs, dim=1).to(xc.dtype)
    return h, new_tail, h[:, -1]


def rglru_block_apply(cfg, p, x: torch.Tensor, state=None):
    """Full Griffin recurrent block. x: (B, S, d).

    state: None (training/prefill from zero state) or
    {"conv": (B, K-1, d), "h": (B, d)} (decode / continued prefill).
    Returns (y, new_state).
    """
    b, s, d = x.shape
    kw = cfg.conv_width - 1
    gate = F.gelu((x @ p["w_gate"]).float(), approximate="tanh").to(x.dtype)
    tail = (torch.zeros((b, kw, d), dtype=x.dtype, device=x.device)
            if state is None else state["conv"].to(x.dtype))
    h_last = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
              if state is None else state["h"].to(x.dtype))

    lc = min(TIME_CHUNK, s)
    while s % lc:
        lc -= 1
    hs = []
    for c0 in range(0, s, lc):
        h, tail, h_last = _chunk_core(cfg, p, x[:, c0:c0 + lc], tail, h_last)
        hs.append(h)
    h = torch.cat(hs, dim=1)

    y = (gate * h) @ p["w_out"]
    return y, {"conv": tail, "h": h_last}
