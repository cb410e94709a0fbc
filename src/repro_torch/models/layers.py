"""Shared transformer layers (port of ``repro.models.layers``): norms,
positional encodings, blocked GQA attention, SwiGLU.

Parameters live in ``Params`` nodes (an ``nn.Module`` per dict of the
reference's parameter tree; ``p["wq"]`` reads a tensor or a child node as the
reference reads its dict), so the apply functions read as the reference's do.
Inits draw from an explicit ``torch.Generator`` on the target device: the same
shapes, dtypes and distributions as the reference's, not its values.

Attention is *blocked*: queries run in chunks, and per chunk the full K/V is
visited with causal/window masking. The dtype flow is the reference's: its
einsums take model-dtype operands with ``preferred_element_type=float32``, so
here the operands are upcast to float32 (exact from bf16) and multiplied in
float32; the softmax runs in float32 and the probabilities are cast to the
model dtype before the PV product. Masks use -1e30, not -inf.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name ("bfloat16", "float32")."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class Params(nn.Module):
    """One node of the parameter tree: tensors become parameters (no
    gradient: serving), nested dicts child nodes; ``p[name]`` reads either."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, dict):
                self.add_module(name, Params(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def dense_init(gen, shape, dtype: torch.dtype, device: torch.device,
               scale: float | None = None) -> torch.Tensor:
    """Scaled standard-normal draws from ``gen``; on the meta device only
    the shape."""
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[0] if len(shape) >= 2 else 1
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def norm_init(cfg, device: torch.device) -> dict:
    if cfg.norm == "layernorm":
        return {"scale": torch.ones((cfg.d_model,), device=device),
                "bias": torch.zeros((cfg.d_model,), device=device)}
    return {"scale": torch.zeros((cfg.d_model,), device=device)}


def apply_norm(cfg, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


# ---------------------------------------------------------------------------
# positional encodings
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """positions: (..., S) -> cos/sin (..., S, dim/2) in float32."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, hd); cos/sin: (B, S, half_rot). Rotates the leading
    ``fraction`` of head dims (stablelm rotates 25%)."""
    hd = x.shape[-1]
    rot = int(hd * fraction)
    half = rot // 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., :half], xr[..., half:]
    c = cos[..., None, :half].to(x.dtype)
    s = sin[..., None, :half].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out, xp], dim=-1) if rot < hd else out


def mrope_angles(positions: torch.Tensor, sections: tuple, theta: float):
    """Multimodal RoPE (qwen2-vl): positions (B, 3, S) for (t, h, w); each
    head-dim section uses its own position stream. Returns cos/sin
    (B, S, sum(sections))."""
    cs, ss = [], []
    for i, sec in enumerate(sections):
        freqs = theta ** (-torch.arange(0, sec, dtype=torch.float32,
                                        device=positions.device)
                          / sum(sections))
        ang = positions[:, i, :].float()[..., None] * freqs
        cs.append(torch.cos(ang))
        ss.append(torch.sin(ang))
    return torch.cat(cs, dim=-1), torch.cat(ss, dim=-1)


def sinusoidal_embedding(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """Absolute sinusoidal position embedding (musicgen): (..., S) ->
    (..., S, dim)."""
    half = dim // 2
    freqs = 10000.0 ** (-torch.arange(0, half, dtype=torch.float32,
                                      device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def positional_angles(cfg, positions: torch.Tensor):
    """cos/sin streams for the configured scheme; None for sinusoidal."""
    hd = cfg.resolved_head_dim
    if cfg.pos_emb == "rope":
        if positions.ndim == 3:  # (B, 3, S) stub passes mrope-style positions
            positions = positions[:, 0, :]
        return rope_angles(positions, int(hd * cfg.rope_fraction),
                           cfg.rope_theta)
    if cfg.pos_emb == "mrope":
        if positions.ndim == 2:  # text-only: all three streams identical
            positions = positions[:, None, :].expand(
                positions.shape[0], 3, positions.shape[1])
        return mrope_angles(positions, cfg.mrope_sections, cfg.rope_theta)
    return None


# ---------------------------------------------------------------------------
# blocked attention
# ---------------------------------------------------------------------------

def softmax(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis, written out as ``jax.nn.softmax`` is."""
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, q_chunk: int = 512,
              q_offset: int = 0) -> torch.Tensor:
    """GQA attention. q: (B, Sq, Hq, hd); k/v: (B, Skv, Hkv, hd).

    Queries run in chunks (``q_chunk`` shrinks to a divisor of Sq); keys and
    values are visited in full per chunk with a float32 softmax. ``window``
    > 0 restricts to a local causal window; ``q_offset`` is the absolute
    position of q[0] relative to k[0].
    """
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = 1.0 / math.sqrt(hd)
    qc = min(q_chunk, sq)
    while sq % qc:
        qc -= 1

    kt = k.permute(0, 2, 3, 1).float()            # (B, Hkv, hd, Skv)
    vt = v.permute(0, 2, 1, 3).float()            # (B, Hkv, Skv, hd)
    kv_idx = torch.arange(skv, device=q.device)
    chunks = []
    for c0 in range(0, sq, qc):
        qs = q[:, c0:c0 + qc]                                     # (B,qc,Hq,hd)
        qg = qs.reshape(b, qc, hkv, g, hd).permute(0, 2, 3, 1, 4)  # (B,Hkv,g,qc,hd)
        scores = torch.einsum("bhgqd,bhdk->bhgqk", qg.float(), kt) * scale
        q_idx = q_offset + c0 + torch.arange(qc, device=q.device)
        mask = torch.ones((qc, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kv_idx[None, :] <= q_idx[:, None]
        if window:
            mask &= kv_idx[None, :] > q_idx[:, None] - window
        scores = torch.where(mask[None, None, None], scores, -1e30)
        p = softmax(scores).to(q.dtype)                           # PV in model dtype
        out = torch.einsum("bhgqk,bhkd->bhgqd", p.float(), vt)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, qc, hq, hd)
        chunks.append(out.to(q.dtype))
    return torch.cat(chunks, dim=1)


# ---------------------------------------------------------------------------
# attention block (pre-norm attn + SwiGLU ffn) — kinds: attn / attn_local / moe
# ---------------------------------------------------------------------------

def attn_params_init(cfg, gen, device: torch.device) -> dict:
    hd = cfg.resolved_head_dim
    dt = dtype_of(cfg.dtype)
    p = {
        "wq": dense_init(gen, (cfg.d_model, cfg.num_heads * hd), dt, device),
        "wk": dense_init(gen, (cfg.d_model, cfg.num_kv_heads * hd), dt, device),
        "wv": dense_init(gen, (cfg.d_model, cfg.num_kv_heads * hd), dt, device),
        "wo": dense_init(gen, (cfg.num_heads * hd, cfg.d_model), dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.num_heads * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((cfg.num_kv_heads * hd,), dtype=dt, device=device)
    return p


def qkv_project(cfg, p, x: torch.Tensor):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    return q, k, v


def attn_apply(cfg, p, x: torch.Tensor, angles, *, window: int = 0
               ) -> torch.Tensor:
    """Self-attention over the full sequence (training / prefill)."""
    b, s, _ = x.shape
    q, k, v = qkv_project(cfg, p, x)
    if angles is not None:
        cos, sin = angles
        q = apply_rope(q, cos, sin, cfg.rope_fraction)
        k = apply_rope(k, cos, sin, cfg.rope_fraction)
    out = attention(q, k, v, causal=True, window=window, q_chunk=cfg.q_chunk)
    return out.reshape(b, s, -1) @ p["wo"]


# ---------------------------------------------------------------------------
# SwiGLU FFN
# ---------------------------------------------------------------------------

def ffn_params_init(cfg, gen, device: torch.device,
                    d_ff: int | None = None) -> dict:
    dt = dtype_of(cfg.dtype)
    f = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (cfg.d_model, f), dt, device),
        "w_up": dense_init(gen, (cfg.d_model, f), dt, device),
        "w_down": dense_init(gen, (f, cfg.d_model), dt, device),
    }


def ffn_apply(p, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
