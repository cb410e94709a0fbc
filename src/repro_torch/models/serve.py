"""Serving (port of ``repro.models.serve``): KV/recurrent caches, prefill, and
single-token decode.

The cache is a list with one dict of tensors per layer, in the model's layer
order, on the model's device (``convert.cache_to_reference`` restacks it into
the reference's per-pattern-position layout). ``decode_step`` writes each
attention layer's new K/V row into its cache in place and returns the same
tensors; recurrent states are replaced.

Decode attention evaluates the query against the full cache with masking,
the scores in float32 over the cache axis. Local-attention blocks cache only
their window, as a rolling buffer at ``pos % window`` with an age mask;
global blocks write at ``min(pos, S_c - 1)``. Recurrent blocks carry O(d) /
O(d^2) state.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers, moe, rglru, rwkv, transformer


# ---------------------------------------------------------------------------
# cache init
# ---------------------------------------------------------------------------

def _attn_cache_len(cfg, kind: str, max_seq: int) -> int:
    if kind == "attn_local":
        return min(cfg.window, max_seq)
    return max_seq


def block_cache_init(cfg, kind: str, batch: int, max_seq: int,
                     device: torch.device) -> dict:
    dt = layers.dtype_of(cfg.dtype)
    hd = cfg.resolved_head_dim

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if kind in ("attn", "attn_local", "moe"):
        s = _attn_cache_len(cfg, kind, max_seq)
        return {"k": zeros(batch, s, cfg.num_kv_heads, hd),
                "v": zeros(batch, s, cfg.num_kv_heads, hd)}
    if kind == "rec":
        return {"conv": zeros(batch, cfg.conv_width - 1, cfg.d_model),
                "h": zeros(batch, cfg.d_model)}
    # rwkv
    nh = cfg.d_model // hd
    return {"shift_t": zeros(batch, cfg.d_model),
            "shift_c": zeros(batch, cfg.d_model),
            "wkv": zeros(batch, nh, hd, hd, dtype=torch.float32)}


def init_cache(cfg, batch: int, max_seq: int, device=None) -> list[dict]:
    """Zero caches for every layer, in layer order, on ``device`` (None: the
    card; "meta": shapes only)."""
    dev = transformer._init_device(device)
    return [block_cache_init(cfg, kind, batch, max_seq, dev)
            for kind in transformer.layer_kinds(cfg)]


# ---------------------------------------------------------------------------
# decode attention (single token against the cache)
# ---------------------------------------------------------------------------

def decode_attention(cfg, p, x: torch.Tensor, cache: dict, pos: int, angles,
                     *, window: int = 0):
    """x: (B, 1, d); cache k/v: (B, S_c, Hkv, hd); pos: absolute position.

    Returns (out (B, 1, d), cache) with this token's K/V written into the
    cache (a rolling buffer indexed mod window for local attention)."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = layers.qkv_project(cfg, p, x)          # (B,1,H*,hd)
    if angles is not None:
        cos, sin = angles
        q = layers.apply_rope(q, cos, sin, cfg.rope_fraction)
        k = layers.apply_rope(k, cos, sin, cfg.rope_fraction)

    ck, cv = cache["k"], cache["v"]
    s_c = ck.shape[1]
    slot = pos % s_c if window else min(pos, s_c - 1)
    ck[:, slot] = k[:, 0]
    cv[:, slot] = v[:, 0]

    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    g = hq // hkv
    qg = q.reshape(b, hkv, g, hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          ck.float()) / math.sqrt(hd)
    kv_idx = torch.arange(s_c, device=x.device)
    if window:
        # rolling buffer: valid entries are the last min(pos+1, window) writes
        age = (slot - kv_idx) % s_c                    # 0 = newest
        mask = age < min(pos + 1, s_c)
    else:
        mask = kv_idx <= pos
    scores = torch.where(mask[None, None, None, :], scores, -1e30)
    probs = layers.softmax(scores)                     # reductions over S_c
    out = torch.einsum("bhgs,bshd->bhgd", probs.to(x.dtype).float(),
                       cv.float())
    out = out.reshape(b, 1, hq * hd).to(x.dtype) @ p["wo"]
    return out, {"k": ck, "v": cv}


# ---------------------------------------------------------------------------
# per-block decode
# ---------------------------------------------------------------------------

def block_decode(cfg, kind: str, p, x: torch.Tensor, cache: dict, pos: int,
                 angles):
    h = layers.apply_norm(cfg, p["norm1"], x)
    if kind in ("attn", "attn_local", "moe"):
        window = cfg.window if kind == "attn_local" else 0
        out, cache = decode_attention(cfg, p["attn"], h, cache, pos, angles,
                                      window=window)
        x = x + out
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        if kind == "moe":
            x = x + moe.moe_apply(cfg, p["moe"], h2)
        else:
            x = x + layers.ffn_apply(p["ffn"], h2)
    elif kind == "rec":
        out, cache = rglru.rglru_block_apply(cfg, p["rec"], h, state=cache)
        x = x + out
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        x = x + layers.ffn_apply(p["ffn"], h2)
    else:  # rwkv
        out, st_t = rwkv.time_mix_apply(
            cfg, p["tmix"], h,
            state={"shift": cache["shift_t"], "wkv": cache["wkv"]})
        x = x + out
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        out, st_c = rwkv.channel_mix_apply(cfg, p["tmix"], h2,
                                           state={"shift": cache["shift_c"]})
        x = x + out
        cache = {"shift_t": st_t["shift"], "wkv": st_t["wkv"],
                 "shift_c": st_c["shift"]}
    return x, cache


# ---------------------------------------------------------------------------
# decode step
# ---------------------------------------------------------------------------

def decode_step(model: transformer.Transformer, cache: list[dict],
                tokens: torch.Tensor, pos: int):
    """One-token decode. tokens: (B, 1) int (or (B, 1, d) embeddings for stub
    frontends); pos: the absolute position (an int). Returns
    (logits (B, V), new_cache)."""
    cfg = model.cfg
    pos = int(pos)
    positions = torch.full((tokens.shape[0], 1), pos, dtype=torch.int32,
                           device=tokens.device)
    x = transformer.embed_inputs(model, tokens, positions)
    angles = layers.positional_angles(cfg, positions)
    new_cache = []
    for kind, p, c in zip(model.kinds, model.blocks, cache):
        x, c = block_decode(cfg, kind, p, x, c, pos, angles)
        new_cache.append(c)
    x = layers.apply_norm(cfg, model.final_norm, x)
    return x[:, 0] @ transformer.lm_head(model), new_cache


# ---------------------------------------------------------------------------
# prefill: full-sequence forward that also populates the cache
# ---------------------------------------------------------------------------

def block_prefill(cfg, kind: str, p, x: torch.Tensor, angles, max_seq: int):
    """Training-path compute + cache capture. Returns (x, cache)."""
    b, s, _ = x.shape
    h = layers.apply_norm(cfg, p["norm1"], x)
    if kind in ("attn", "attn_local", "moe"):
        window = cfg.window if kind == "attn_local" else 0
        q, k, v = layers.qkv_project(cfg, p["attn"], h)
        if angles is not None:
            cos, sin = angles
            q = layers.apply_rope(q, cos, sin, cfg.rope_fraction)
            k = layers.apply_rope(k, cos, sin, cfg.rope_fraction)
        out = layers.attention(q, k, v, causal=True, window=window,
                               q_chunk=cfg.q_chunk)
        x = x + out.reshape(b, s, -1) @ p["attn"]["wo"]
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        if kind == "moe":
            x = x + moe.moe_apply(cfg, p["moe"], h2)
        else:
            x = x + layers.ffn_apply(p["ffn"], h2)
        s_c = _attn_cache_len(cfg, kind, max_seq)
        if window and s <= s_c:
            # rolling buffer: the s tokens land at slots (pos % window)
            idx = torch.arange(s, device=x.device) % s_c
            ck = k.new_zeros((b, s_c, *k.shape[2:]))
            cv = v.new_zeros((b, s_c, *v.shape[2:]))
            ck[:, idx] = k
            cv[:, idx] = v
        else:
            take = min(s, s_c)
            pad = s_c - take
            ck = torch.nn.functional.pad(k[:, -take:], (0, 0, 0, 0, 0, pad))
            cv = torch.nn.functional.pad(v[:, -take:], (0, 0, 0, 0, 0, pad))
            if window:  # rolling alignment for long prefill
                roll = s % s_c
                ck = torch.roll(ck, roll, dims=1)
                cv = torch.roll(cv, roll, dims=1)
        cache = {"k": ck, "v": cv}
    elif kind == "rec":
        out, cache = rglru.rglru_block_apply(cfg, p["rec"], h, state=None)
        x = x + out
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        x = x + layers.ffn_apply(p["ffn"], h2)
    else:  # rwkv
        out, st_t = rwkv.time_mix_apply(cfg, p["tmix"], h, state=None)
        x = x + out
        h2 = layers.apply_norm(cfg, p["norm2"], x)
        out, st_c = rwkv.channel_mix_apply(cfg, p["tmix"], h2, state=None)
        x = x + out
        cache = {"shift_t": st_t["shift"], "shift_c": st_c["shift"],
                 "wkv": st_t["wkv"]}
    return x, cache


def prefill(model: transformer.Transformer, inputs: torch.Tensor,
            positions: torch.Tensor, max_seq: int):
    """Forward over the prompt; returns (last-token logits (B, V), cache)."""
    cfg = model.cfg
    x = transformer.embed_inputs(model, inputs, positions)
    angles = layers.positional_angles(cfg, positions)
    cache = []
    for kind, p in zip(model.kinds, model.blocks):
        x, c = block_prefill(cfg, kind, p, x, angles, max_seq)
        cache.append(c)
    x = layers.apply_norm(cfg, model.final_norm, x)
    return x[:, -1] @ transformer.lm_head(model), cache


# ---------------------------------------------------------------------------
# host-side generation loop (examples / integration tests)
# ---------------------------------------------------------------------------

def generate(model: transformer.Transformer, prompt_tokens: torch.Tensor,
             num_steps: int, max_seq: int, temperature: float = 0.0,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """Greedy (temperature 0) or temperature sampling from ``generator`` (a
    generator on the model's device). prompt_tokens: (B, S) int."""
    if temperature > 0.0 and generator is None:
        raise ValueError("temperature sampling needs a generator")
    b, s = prompt_tokens.shape[0], prompt_tokens.shape[1]
    positions = torch.arange(s, device=prompt_tokens.device)[None, :].expand(
        b, s)
    logits, cache = prefill(model, prompt_tokens, positions, max_seq)
    out = []
    for t in range(num_steps):
        if temperature > 0.0:
            probs = layers.softmax(logits.float() / temperature)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        out.append(nxt)
        logits, cache = decode_step(model, cache, nxt[:, None], s + t)
    return torch.stack(out, dim=1)
