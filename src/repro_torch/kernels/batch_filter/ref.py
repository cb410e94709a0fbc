"""Plain PyTorch version of the sharded joint-bucket filter.

``out[s, q, e] = live[s, e] & any_w(queries[s, q, w] & entries[s, e, w] !=
0)``, a few queries at a time so the (S, q, E, W) AND stays small. It is the
CPU path of ``ops.batch_filter_sharded`` and the CUDA kernel's oracle.
"""
from __future__ import annotations

import torch

_CHUNK_ELEMS = 1 << 25


def batch_filter_sharded_ref(queries: torch.Tensor, entries: torch.Tensor,
                             live: torch.Tensor) -> torch.Tensor:
    """queries (S, Q, W) int32; entries (S, E, W) int32; live (S, E) bool ->
    (S, Q, E) bool."""
    s, q, w = queries.shape
    e = entries.shape[1]
    out = torch.empty((s, q, e), dtype=torch.bool, device=queries.device)
    step = max(1, _CHUNK_ELEMS // max(1, s * e * w))
    for i in range(0, q, step):
        joint = (queries[:, i:i + step, None, :] & entries[:, None, :, :]) != 0
        out[:, i:i + step] = joint.any(dim=-1) & live[:, None, :]
    return out
