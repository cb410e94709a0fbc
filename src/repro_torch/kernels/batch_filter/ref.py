"""Plain PyTorch versions of the joint-bucket filters.

``out[s, q, e] = live[s, e] & any_w(queries[s, q, w] & entries[s, e, w] !=
0)``, a few queries at a time so the (S, q, E, W) AND stays small;
``batch_filter_ref`` is the same at S=1 without the shard axis. They are the
CPU paths of ``ops`` and the CUDA kernel's oracles.
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


def batch_filter_ref(queries: torch.Tensor, entries: torch.Tensor,
                     live: torch.Tensor) -> torch.Tensor:
    """queries (Q, W) int32; entries (E, W) int32; live (E,) bool -> (Q, E)
    bool."""
    return batch_filter_sharded_ref(queries[None], entries[None],
                                    live[None])[0]
