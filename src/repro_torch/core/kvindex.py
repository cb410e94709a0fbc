"""HippoKV: Hippo-style page summaries over a KV cache (beyond-paper) (port
of ``repro.core.kvindex``).

The paper's structure (page ranges + bucket-bitmap summaries + AND-filter)
applied to long-context decode: the "table" is the key cache, a "page" is a
block of ``page_size`` consecutive cache positions, and the indexed
"attribute" is the key's value in each of the ``num_channels`` key dims of
highest variance. Per page and channel the bitmap marks the equi-depth
buckets the page's values fall in; a decode query keeps, per channel, the
``keep_buckets`` outermost buckets in the direction of sign(q_c), and a page
survives if at least ``min_channels`` channels share a bucket with it.

KV pruning is approximate (a dropped page drops its softmax mass), so
``hippo_kv_attention`` returns the kept mass beside the output.

Everything runs on the cache's device. The bucket ids go through the bucket
probe (kernel C, ``kernels.bucketize``), one launch per channel, with NaN
sorted last as the reference's ``searchsorted``; the CPU takes its plain
version. The bounds replay, on the device, what XLA:CPU makes of the
reference's ``jnp.quantile`` along axis 0 (``_quantile``) and of its
strict-monotone step (``_monotone``), bit for bit.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.histogram import _quantile_weights
from repro_torch.device import resolve_device
from repro_torch.kernels.bucketize import bucketize_values


@dataclass(frozen=True)
class KVIndexConfig:
    page_size: int = 64          # cache positions per summarized page
    num_channels: int = 8        # key channels summarized per head
    resolution: int = 16         # histogram buckets per channel
    keep_buckets: int = 4        # query-side: outermost buckets selected


class KVIndex:
    """Per-(batch, head) page summaries of a key cache."""

    def __init__(self, cfg: KVIndexConfig, channels: torch.Tensor,
                 bounds: torch.Tensor, bitmaps: torch.Tensor):
        self.cfg = cfg
        self.channels = channels   # (C,) int32: key dims summarized
        self.bounds = bounds       # (C, R+1) f32: per-channel bucket bounds
        self.bitmaps = bitmaps     # (B, H, P, C, W) int32 bits of uint32

    @property
    def num_pages(self) -> int:
        return self.bitmaps.shape[2]

    def nbytes(self) -> int:
        return int(self.bitmaps.numel()) * 4 + int(self.bounds.numel()) * 4


def _cache_tensor(x, device) -> torch.Tensor:
    """A tensor stays on its device unless ``device`` names another; an
    array goes to ``device`` (None: the card)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def _quantile(sel: torch.Tensor, resolution: int) -> torch.Tensor:
    """``jnp.quantile(sel, linspace(0, 1, R+1), axis=0).T`` of (N, C) float32
    values on their device: (C, R+1), with the gather indices and weights of
    ``histogram._quantile_weights``. Along axis 0 XLA:CPU contracts the
    interpolation the other way round from the 1-D sample's: the high term
    is a float32 product and the low term is fused in by one FMA (the 1-D
    form differs in ~1 bound in 6 here), replayed as a float64 sum rounded
    to float32 (the float32 product is exact in float64)."""
    a = torch.sort(sel, dim=0).values
    lo_i, hi_i, lw, hw = (torch.from_numpy(w).to(sel.device) for w in
                          _quantile_weights(a.shape[0], resolution))
    hi_term = a[hi_i] * hw[:, None]
    out = (a[lo_i].to(torch.float64) * lw.to(torch.float64)[:, None]
           + hi_term.to(torch.float64)).to(torch.float32)
    return out.T.contiguous()


def _monotone(bounds: torch.Tensor) -> torch.Tensor:
    """``bounds + arange(R+1) * eps`` with ``eps = (last - first + 1) *
    1e-6`` per channel, in float32 with no contraction (XLA:CPU does not
    fuse this product and sum; the FMA form differs in ~1 bound in 500)."""
    eps = ((bounds[:, -1:] - bounds[:, :1]) + 1.0) * np.float32(1e-6)
    steps = torch.arange(bounds.shape[1], dtype=torch.float32,
                         device=bounds.device)
    return bounds + steps * eps


def build_kv_index(cfg: KVIndexConfig, keys, device=None) -> KVIndex:
    """keys: (B, S, H, hd) with S % page_size == 0, a tensor (summarized on
    its device) or an array (on ``device``, None: the card)."""
    kf = _cache_tensor(keys, device).to(torch.float32)
    b, s, h, hd = kf.shape
    p = s // cfg.page_size
    c, r = cfg.num_channels, cfg.resolution
    dev = kf.device
    # pick the highest-variance key dims as summary channels
    flat = kf.reshape(-1, hd)
    var = ((flat - flat.mean(dim=0)) ** 2).mean(dim=0)
    channels = torch.sort(-var, stable=True).indices[:c].to(torch.int32)
    sel = kf[..., channels.long()]                        # (B, S, H, C)
    # equi-depth bounds per channel (global across the cache)
    bounds = _monotone(_quantile(sel.reshape(-1, c), r))
    # bucketize: one probe launch per channel
    ids = torch.stack([bucketize_values(sel[..., j].reshape(-1).contiguous(),
                                        bounds[j].contiguous(), r)
                       for j in range(c)], dim=-1)       # (B*S*H, C)
    ids = ids.reshape(b, p, cfg.page_size, h, c).to(torch.int64)
    # per-page bitmaps: set bit ids of (b, page, head, channel)
    page_bits = torch.zeros((b, p, h, c, r), dtype=torch.bool, device=dev)
    row = torch.arange(b * p, device=dev).reshape(b, p, 1, 1, 1)
    cell = (row * h + torch.arange(h, device=dev).reshape(1, 1, 1, h, 1)) \
        * c + torch.arange(c, device=dev)
    page_bits.view(-1)[(cell * r + ids).reshape(-1)] = True
    bitmaps = bm.from_bool(page_bits).permute(0, 2, 1, 3, 4).contiguous()
    return KVIndex(cfg, channels, bounds, bitmaps)


def query_page_mask(index: KVIndex, q: torch.Tensor,
                    min_channels: int = 1) -> torch.Tensor:
    """q: (B, H, hd) single decode query -> (B, H, P) bool pages to keep.

    Per channel, select the ``keep_buckets`` outermost buckets in the
    direction of sign(q_c) (largest |q_c*k_c| upper bound); a page survives
    if at least ``min_channels`` channels have a joint bucket (Algorithm 1's
    AND-filter per channel, vote-combined across channels).
    """
    cfg = index.cfg
    qc = q.to(torch.float32)[..., index.channels.long()]  # (B, H, C)
    r = cfg.resolution
    idx = torch.arange(r, device=q.device)
    hi_mask = idx >= (r - cfg.keep_buckets)               # top buckets
    lo_mask = idx < cfg.keep_buckets                      # bottom buckets
    want_bits = torch.where(qc[..., None] >= 0, hi_mask, lo_mask)
    want = bm.from_bool(want_bits)                        # (B, H, C, W)
    joint = bm.any_joint(index.bitmaps, want[:, :, None])  # (B, H, P, C)
    return joint.sum(dim=-1) >= min_channels              # (B, H, P)


def hippo_kv_attention(q: torch.Tensor, keys: torch.Tensor,
                       values: torch.Tensor, page_mask: torch.Tensor,
                       page_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode attention over kept pages only (others masked out).

    q: (B, H, hd); keys/values: (B, S, H, hd); page_mask: (B, H, P).
    Returns (out (B, H, hd), kept_mass (B, H)), kept_mass the softmax mass
    retained against full attention. Plain float32 products, as the
    reference's (outside any Pallas kernel); they run at the process's
    float32 matmul precision, PyTorch's default "highest".
    """
    b, s, h, hd = keys.shape
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhd,bshd->bhs", q.to(torch.float32),
                          keys.to(torch.float32)) * scale
    full = torch.softmax(scores, dim=-1)
    pos_mask = page_mask.repeat_interleave(page_size, dim=-1)[..., :s]
    masked = torch.where(pos_mask, scores, -1e30)
    probs = torch.softmax(masked, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", probs, values.to(torch.float32))
    kept_mass = (full * pos_mask).sum(dim=-1)
    return out.to(q.dtype), kept_mass
