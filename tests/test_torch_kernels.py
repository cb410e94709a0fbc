"""Port parity: each kernel wrapper's CPU path (the plain PyTorch version)
against the reference's Pallas kernel in interpret mode and its jnp oracle.

``batch_filter`` in the port takes per-shard queries (S, Q, W) and a fused
live mask; the reference kernel shares one (Q, W) query set across shards.
So it is compared with the reference kernel on identical shard rows, and
with the reference oracle shard by shard on distinct rows. ``compact_inspect``
in the port reads pages through the selection index instead of a gathered
slab; the reference gets the slab gathered explicitly.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.batch_filter.ops import batch_filter_sharded as pallas_bf
from repro.kernels.batch_filter.ref import batch_filter_sharded_ref as jnp_bf
from repro.kernels.bucketize.ops import bucketize_values as pallas_bk
from repro.kernels.compact_inspect.ops import compact_inspect as pallas_ci
from repro_torch.kernels.batch_filter import batch_filter_sharded
from repro_torch.kernels.bucketize import (bucketize_rows_words,
                                           bucketize_values)
from repro_torch.kernels.compact_inspect import compact_inspect


def _words(rng, shape, density) -> np.ndarray:
    bits = rng.random((*shape, 32)) < density
    w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    w = w.astype(np.uint32)
    w.reshape(-1)[::5] |= np.uint32(1 << 31)
    return w


def _t(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, order="C"))


@pytest.mark.parametrize("s,q,e,w", [(3, 10, 130, 13), (1, 8, 128, 2),
                                     (2, 17, 129, 16), (1, 17, 257, 17),
                                     (3, 5, 65, 32)])
def test_batch_filter_plain_equals_pallas_on_shared_rows(s, q, e, w):
    rng = np.random.default_rng(s + q)
    queries = _words(rng, (q, w), 0.03)
    queries[1] = 0
    entries = _words(rng, (s, e, w), 0.03)
    ref = np.asarray(pallas_bf(jnp.asarray(queries), jnp.asarray(entries),
                               interpret=True))
    live = torch.ones((s, e), dtype=torch.bool)
    got = batch_filter_sharded(_t(np.broadcast_to(queries, (s, q, w))),
                               _t(entries), live)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), ref.astype(bool))


def test_batch_filter_plain_equals_oracle_per_shard_with_live_mask():
    rng = np.random.default_rng(9)
    s, q, e, w = 4, 6, 50, 13
    queries = _words(rng, (s, q, w), 0.04)
    entries = _words(rng, (s, e, w), 0.04)
    live = rng.random((s, e)) < 0.7
    got = batch_filter_sharded(_t(queries), _t(entries), torch.from_numpy(live))
    for k in range(s):
        ref = np.asarray(jnp_bf(jnp.asarray(queries[k]),
                                jnp.asarray(entries[k:k + 1])))[0]
        assert np.array_equal(got[k].numpy(), ref.astype(bool) & live[k][None])


def test_compact_inspect_plain_equals_pallas_on_gathered_slab():
    rng = np.random.default_rng(4)
    s, p, c, m, q = 2, 30, 50, 20, 9
    keys = rng.integers(0, 60, (s, p, c)).astype(np.float32)
    valid = rng.random((s, p, c)) < 0.9
    sel = np.sort(rng.choice(p, (s, m - 4), replace=True), axis=1)
    sel = np.concatenate([sel, np.full((s, 4), p)], axis=1).astype(np.int32)
    sel_mask = (rng.random((s, q, m)) < 0.6) & (sel < p)[:, None, :]
    lo = rng.integers(0, 60, q).astype(np.float32)
    hi = (lo + rng.integers(-3, 20, q)).astype(np.float32)
    got = compact_inspect(_t(keys), _t(valid), _t(sel), _t(sel_mask),
                          _t(lo), _t(hi))
    assert got.dtype == torch.int32 and got.shape == (s, q, m)
    for k in range(s):
        in_range = sel[k] < p
        idx = np.where(in_range, sel[k], 0)
        slab_k = np.where(in_range[:, None], keys[k][idx], 0.0)
        slab_v = valid[k][idx] & in_range[:, None]
        ref = np.asarray(pallas_ci(jnp.asarray(slab_k), jnp.asarray(slab_v),
                                   jnp.asarray(sel_mask[k]), jnp.asarray(lo),
                                   jnp.asarray(hi), interpret=True))
        assert np.array_equal(got[k].numpy(), ref)


def test_bucketize_plain_equals_pallas():
    rng = np.random.default_rng(2)
    h = 400
    bounds = np.sort(rng.uniform(-100, 100, h + 1)).astype(np.float32)
    vals = np.concatenate([rng.uniform(-120, 120, 2000), bounds,
                           [3.4e38, -3.4e38]]).astype(np.float32)
    ref = np.asarray(pallas_bk(jnp.asarray(vals), jnp.asarray(bounds), h,
                               interpret=True))
    got = bucketize_values(_t(vals), _t(bounds), h, nan_last=False)
    assert np.array_equal(got.numpy(), ref)


EDGE_VALUES = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -1.0, 1.0, 2.0,
                        3.0, 3.4e38, -3.4e38], np.float32)


def _edge_bounds(kind, rng, h):
    b = np.cumsum(rng.random(h + 1) + 0.01).astype(np.float32)
    if kind == "tied":
        b = np.sort(rng.integers(0, max(2, h // 8), h + 1)).astype(np.float32)
    elif kind == "equal":
        b = np.full(h + 1, 2.0, np.float32)
    elif kind == "infinite ends":
        b[0], b[-1] = -np.inf, np.inf
    elif kind == "signed zeros":
        b = np.sort(np.concatenate([rng.uniform(-3, 3, h - 1),
                                    [-0.0, 0.0]])).astype(np.float32)
    return b


# The plain version against the Pallas kernel on the edges the CUDA kernel's
# rank table must keep: NaN, +-0 and +-inf values, values equal to bounds,
# runs of tied bounds, a zero span, +-inf end bounds, signed zeros among the
# bounds; N off the Pallas tile and the CUDA kernel's vectors.
@pytest.mark.parametrize("kind", ["increasing", "tied", "equal",
                                  "infinite ends", "signed zeros"])
@pytest.mark.parametrize("h,n", [(1, 5), (7, 129), (64, 1027), (400, 2003)])
def test_bucketize_plain_equals_pallas_on_edge_values(h, n, kind):
    rng = np.random.default_rng(h + n)
    bounds = _edge_bounds(kind, rng, h)
    pool = np.concatenate([EDGE_VALUES, bounds, rng.uniform(-5, 450, 50)])
    vals = rng.choice(pool, n).astype(np.float32)
    ref = np.asarray(pallas_bk(jnp.asarray(vals), jnp.asarray(bounds), h,
                               interpret=True))
    got = bucketize_values(_t(vals), _t(bounds), h, nan_last=False)
    assert np.array_equal(got.numpy(), ref)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    f = torch.zeros(4)
    with pytest.raises(TypeError):
        bucketize_values(f.double(), f, 3)
    with pytest.raises(ValueError):
        bucketize_values(torch.zeros(8)[::2], f, 3)           # not contiguous
    with pytest.raises(ValueError):
        bucketize_values(torch.zeros(2, device="meta"),
                         torch.zeros(4, device="meta"), 3)    # not cpu/cuda
    q = torch.zeros((2, 3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        batch_filter_sharded(q, torch.zeros((2, 5, 3), dtype=torch.int32),
                             torch.ones((2, 5), dtype=torch.bool))
    with pytest.raises(TypeError):
        compact_inspect(torch.zeros((1, 2, 3)), torch.zeros((1, 2, 3)),
                        torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros((1, 1, 1), dtype=torch.bool),
                        torch.zeros(1), torch.zeros(1))


@pytest.mark.parametrize("bad", ["his shape", "his dtype", "nonempty dtype",
                                 "nonempty shape"])
def test_bucketize_rows_words_refuses_mismatched_intervals(bad):
    q = 5
    args = {"los": torch.zeros(q), "his": torch.ones(q),
            "nonempty": torch.ones(q, dtype=torch.bool)}
    args.update({"his shape": {"his": torch.ones(q + 1)},
                 "his dtype": {"his": torch.ones(q, dtype=torch.float64)},
                 "nonempty dtype": {"nonempty": torch.ones(q)},
                 "nonempty shape": {"nonempty": torch.ones(
                     q - 1, dtype=torch.bool)}}[bad])
    bounds = torch.arange(9, dtype=torch.float32)[None].repeat(2, 1)
    with pytest.raises((TypeError, ValueError)):
        bucketize_rows_words(args["los"], args["his"], args["nonempty"],
                             bounds, 8)
    got = bucketize_rows_words(torch.zeros(q), torch.ones(q),
                               torch.ones(q, dtype=torch.bool), bounds, 8)
    assert got.shape == (2, q, 1) and got.dtype == torch.int32
