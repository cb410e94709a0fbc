"""The plain versions of the two inspections (``compact_inspect_ref`` and
``page_inspect_many_ref``, the CUDA kernels' oracles and the CPU path)
against the reference's Pallas kernels in interpret mode, on edge values.

Keys and interval endpoints come from one small pool (NaN, both zeros, both
infinities, the float32 extremes and a few small values), so keys tie with
endpoints, endpoints tie with each other, and lo == hi and lo > hi come up
in every batch. The shapes cover C=1, C above a warp, Q=1, Q=65 and Q above
the kernels' 64-query tiles, and pads in the selection. The reference's
``compact_inspect`` takes the gathered slab, so it gets the slab gathered
explicitly; its ``page_inspect`` takes one interval, so it runs once per
(shard, query) and its page counts are summed.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.compact_inspect.ops import compact_inspect as pallas_ci
from repro.kernels.page_inspect.ops import page_inspect as pallas_pi
from repro_torch.kernels.compact_inspect import ops as ci_ops
from repro_torch.kernels.page_inspect import ops as pi_ops

EDGE_VALUES = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -1.0, 1.0, 2.0,
                        3.0, 3.4e38, -3.4e38], np.float32)


def _edge_case(seed, shape, q):
    rng = np.random.default_rng(seed)
    keys = rng.choice(EDGE_VALUES, shape)
    keys = np.where(rng.random(shape) < 0.3,
                    rng.integers(-2, 5, shape).astype(np.float32), keys)
    valid = rng.random(shape) < 0.85
    lo = rng.choice(EDGE_VALUES, q)
    hi = np.where(rng.random(q) < 0.3, lo,
                  rng.choice(EDGE_VALUES, q)).astype(np.float32)
    return rng, keys, valid, lo, hi


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("s,p,c,m,q", [(1, 1, 1, 1, 1), (2, 30, 1, 70, 65),
                                       (1, 9, 7, 20, 2), (3, 40, 50, 33, 64),
                                       (1, 12, 33, 9, 130),
                                       (2, 6, 300, 5, 16)])
def test_compact_inspect_plain_equals_pallas_on_edge_values(seed, s, p, c, m,
                                                            q):
    rng, keys, valid, lo, hi = _edge_case(seed, (s, p, c), q)
    sel = np.sort(rng.integers(0, p + 3, (s, m)), axis=1).astype(np.int32)
    sel_mask = rng.random((s, q, m)) < 0.8
    got = ci_ops.compact_inspect(*(torch.from_numpy(a) for a in (
        keys, valid, sel, sel_mask, lo, hi)))
    assert got.dtype == torch.int32 and got.shape == (s, q, m)
    for k in range(s):
        in_range = sel[k] < p                      # pads select nothing
        idx = np.where(in_range, sel[k], 0)
        slab_k = np.where(in_range[:, None], keys[k][idx], 0.0)
        slab_v = valid[k][idx] & in_range[:, None]
        want = np.asarray(pallas_ci(jnp.asarray(slab_k), jnp.asarray(slab_v),
                                    jnp.asarray(sel_mask[k]), jnp.asarray(lo),
                                    jnp.asarray(hi), interpret=True))
        assert np.array_equal(got[k].numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("s,p,c,q", [(1, 1, 1, 1), (2, 70, 1, 65),
                                     (1, 9, 7, 2), (3, 40, 50, 64),
                                     (1, 33, 33, 130), (2, 6, 300, 16)])
def test_page_inspect_many_plain_equals_pallas_on_edge_values(seed, s, p, c,
                                                              q):
    rng, keys, valid, lo, hi = _edge_case(seed, (s, p, c), q)
    page_mask = rng.random((s, q, p)) < 0.8
    got = pi_ops.page_inspect_many(*(torch.from_numpy(a) for a in (
        keys, valid, page_mask, lo, hi)))
    assert got.dtype == torch.int32 and got.shape == (s, q)
    want = np.zeros((s, q), np.int32)
    for k in range(s):
        for j in range(q):
            _, counts = pallas_pi(jnp.asarray(keys[k]), jnp.asarray(valid[k]),
                                  jnp.asarray(page_mask[k, j]), lo[j], hi[j],
                                  interpret=True)
            want[k, j] = int(np.asarray(counts).sum())
    assert np.array_equal(got.numpy(), want)


# The single-query plain version (the tuple mask and the page counts) against
# the Pallas kernel: C around the CUDA kernel's 16-tuple runs, P off its
# 64-page tile, masks drawn, all set and all clear, edge keys and intervals.
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("p,c", [(1, 1), (65, 7), (3, 15), (63, 16),
                                 (5, 17), (70, 50), (2, 300)])
def test_page_inspect_plain_equals_pallas_on_edge_values(seed, p, c):
    rng, keys, valid, lo, hi = _edge_case(seed, (p, c), 6)
    masks = (rng.random(p) < 0.6, np.ones(p, bool), np.zeros(p, bool))
    for mask in masks:
        for a, b in zip(lo, hi):
            qual, counts = pi_ops.page_inspect(
                torch.from_numpy(keys), torch.from_numpy(valid),
                torch.from_numpy(mask), float(a), float(b))
            want_q, want_c = pallas_pi(jnp.asarray(keys), jnp.asarray(valid),
                                       jnp.asarray(mask), a, b,
                                       interpret=True)
            assert qual.dtype == torch.bool and counts.dtype == torch.int32
            assert np.array_equal(qual.numpy(), np.asarray(want_q))
            assert np.array_equal(counts.numpy(), np.asarray(want_c))
