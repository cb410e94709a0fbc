"""CUDA kernels of the PyTorch port against their plain versions, on the card.

Every kernel test here needs a CUDA card and skips without one (the
condition is evaluated when the test runs, not at import). On a machine with
a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The module imports torch and the port only (no JAX), so it runs where JAX is
not installed. The build tests at the bottom run everywhere.
"""
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core.baselines import BPlusTree, FullScan, MinMaxIndex
from repro_torch.core.hippo import HippoIndex
from repro_torch.core.partition import ShardedHippoIndex
from repro_torch.core.predicate import Predicate
from repro_torch.kernels import _build
from repro_torch.kernels.batch_filter import ops as bf_ops
from repro_torch.kernels.bitmap_and import ops as ba_ops
from repro_torch.kernels.bucketize import kernel as bk_kernel
from repro_torch.kernels.bucketize import ops as bk_ops
from repro_torch.kernels.compact_inspect import ops as ci_ops
from repro_torch.kernels.page_inspect import kernel as pi_kernel
from repro_torch.kernels.page_inspect import ops as pi_ops
from repro_torch.runtime.engine import QueryEngine
from repro_torch.storage.table import PagedTable

needs_cuda = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="needs a CUDA card")

BIT31 = int(np.uint32(1 << 31).view(np.int32))


def _words(rng, shape, density):
    bits = rng.random((*shape, 32)) < density
    w = (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1)
    return torch.from_numpy(w.astype(np.uint32).view(np.int32))


# Shapes at the edges of the tensor-core tiling: Q across the 16-query m-tiles
# and the 64-query pass (1, 16, 17, 64, 65, 130), W across the 8-word k-steps
# (1, 2, 8, 9, 13, 16, 17, 24, 32), E off the 256- and 128-entry tiles and
# E = 1 ((4, 64, 1, 13) is plan_batch's routing summary test); rows of the
# (S, Q, E) output then start at every alignment.
BATCH_FILTER_SHAPES = [(3, 70, 300, 13), (1, 1, 1, 2), (2, 65, 129, 32),
                       (4, 64, 1024, 13), (4, 64, 1, 13), (1, 1, 300, 13),
                       (2, 16, 257, 1), (1, 17, 513, 8), (3, 64, 255, 9),
                       (1, 65, 1000, 16), (2, 130, 129, 17), (1, 33, 777, 24),
                       (2, 64, 2049, 13), (1, 17, 3, 32)]


@needs_cuda
@pytest.mark.parametrize("s,q,e,w", BATCH_FILTER_SHAPES)
def test_batch_filter_kernel_equals_plain(s, q, e, w):
    rng = np.random.default_rng(s * 1000 + q)
    qb = _words(rng, (s, q, w), 0.02)
    qb[:, ::7] = 0
    qb[:, 1::5, -1] |= BIT31
    ent = _words(rng, (s, e, w), 0.05)
    ent[:, ::3, -1] = BIT31
    live = torch.from_numpy(rng.random((s, e)) < 0.8)
    want = bf_ops.batch_filter_sharded(qb, ent, live)
    got = bf_ops.batch_filter_sharded(qb.cuda(), ent.cuda(), live.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@needs_cuda
def test_batch_filter_kernel_with_dead_slots():
    # live all false in one shard, slots at and past num_slots in another
    rng = np.random.default_rng(13)
    s, q, e, w = 3, 65, 700, 13
    qb = _words(rng, (s, q, w), 0.3)
    ent = _words(rng, (s, e, w), 0.3)
    live = torch.from_numpy(rng.random((s, e)) < 0.9)
    live[0] = False
    live[2, 400:] = False
    want = bf_ops.batch_filter_sharded(qb, ent, live)
    got = bf_ops.batch_filter_sharded(qb.cuda(), ent.cuda(), live.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert not want[0].any() and not want[2, :, 400:].any()


@needs_cuda
def test_batch_filter_kernel_equals_plain_on_drawn_shapes():
    @settings(max_examples=40, deadline=None, database=None)
    @given(seed=st.integers(0, 2**32 - 1), s=st.integers(1, 4),
           q=st.sampled_from([1, 2, 15, 16, 17, 63, 64, 65, 128, 130]),
           e=st.integers(1, 1100), w=st.integers(1, 32),
           density=st.sampled_from([0.0, 0.01, 0.1, 0.5, 1.0]))
    def check(seed, s, q, e, w, density):
        rng = np.random.default_rng(seed)
        qb = _words(rng, (s, q, w), density)
        ent = _words(rng, (s, e, w), density)
        ent[:, ::2, -1] |= BIT31
        live = torch.from_numpy(rng.random((s, e)) < 0.9)
        want = bf_ops.batch_filter_sharded(qb, ent, live)
        got = bf_ops.batch_filter_sharded(qb.cuda(), ent.cuda(), live.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)

    check()


@needs_cuda
@pytest.mark.parametrize("s,p,c,m,q", [(2, 40, 50, 1, 5), (3, 70, 50, 33, 67),
                                       (1, 5, 7, 40, 3), (2, 300, 50, 256, 64),
                                       (1, 20, 300, 17, 9), (2, 30, 1, 70, 1),
                                       (2, 3, 2100, 4, 9),
                                       (1, 4, 300, 6, 600)])
def test_compact_inspect_kernel_equals_plain(s, p, c, m, q):
    rng = np.random.default_rng(s * 1000 + m)
    keys = torch.from_numpy(rng.integers(0, 100, (s, p, c)).astype(np.float32))
    valid = torch.from_numpy(rng.random((s, p, c)) < 0.9)
    sel = np.minimum(np.sort(rng.integers(0, p + p // 2, (s, m)), axis=1), p)
    sel = torch.from_numpy(sel.astype(np.int32))
    sel_mask = torch.from_numpy(rng.random((s, q, m)) < 0.7)
    lo = rng.integers(0, 100, q).astype(np.float32)
    hi = lo + rng.integers(-5, 30, q).astype(np.float32)   # some empty
    los, his = torch.from_numpy(lo), torch.from_numpy(hi)
    want = ci_ops.compact_inspect(keys, valid, sel, sel_mask, los, his)
    got = ci_ops.compact_inspect(*(t.cuda() for t in (keys, valid, sel,
                                                      sel_mask, los, his)))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@needs_cuda
@pytest.mark.parametrize("h", [400, 64, 7, 1])
def test_bucketize_kernel_equals_plain(h):
    rng = np.random.default_rng(h)
    b = np.cumsum(rng.random(h + 1) + 0.01).astype(np.float32)
    v = np.concatenate([rng.uniform(b[0] - 5, b[-1] + 5, 5000), b,
                        [3.4e38, -3.4e38]]).astype(np.float32)
    bounds, vals = torch.from_numpy(b), torch.from_numpy(v)
    want = bk_ops.bucketize_values(vals, bounds, h)
    got = bk_ops.bucketize_values(vals.cuda(), bounds.cuda(), h)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@needs_cuda
@pytest.mark.parametrize("q,e,w", [(70, 300, 13), (1, 1, 2), (65, 129, 32),
                                   (64, 1024, 13), (1, 257, 13), (16, 1, 1),
                                   (17, 513, 8), (64, 255, 9), (65, 1001, 16),
                                   (130, 129, 17), (33, 777, 24),
                                   (64, 2049, 13)])
def test_batch_filter_unsharded_kernel_equals_plain(q, e, w):
    rng = np.random.default_rng(q * 1000 + e)
    qb = _words(rng, (q, w), 0.02)
    qb[::7] = 0
    qb[1::5, -1] |= BIT31
    ent = _words(rng, (e, w), 0.05)
    ent[::3, -1] = BIT31
    live = torch.from_numpy(rng.random(e) < 0.8)
    want = bf_ops.batch_filter(qb, ent, live)
    got = bf_ops.batch_filter(qb.cuda(), ent.cuda(), live.cuda())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@needs_cuda
@pytest.mark.parametrize("s,e", [(2, 469), (3, 1001), (4, 257)])
def test_batch_filter_unsharded_kernel_on_a_shard_view(s, e):
    # a routed dispatch hands D shard k of an (S, E, W) stack: with odd E its
    # base is 4 B aligned only, and its live bytes start at any byte
    rng = np.random.default_rng(s + e)
    qb = _words(rng, (64, 13), 0.03)
    ent = _words(rng, (s, e, 13), 0.1)
    ent[:, ::3, -1] = BIT31
    live = torch.from_numpy(rng.random((s, e)) < 0.8)
    ent_c, live_c = ent.cuda(), live.cuda()
    assert any(ent_c[k].data_ptr() % 16 for k in range(1, s))
    for k in range(1, s):
        want = bf_ops.batch_filter(qb, ent[k], live[k])
        got = bf_ops.batch_filter(qb.cuda(), ent_c[k], live_c[k])
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


@needs_cuda
@pytest.mark.parametrize("e,w", [(1, 1), (255, 13), (257, 13), (3000, 32),
                                 (1000, 2)])
def test_bitmap_and_kernel_equals_plain(e, w):
    rng = np.random.default_rng(e + w)
    ent = _words(rng, (e, w), 0.05)
    ent[::3, -1] = BIT31
    live = torch.from_numpy(rng.random(e) < 0.8)
    for query in (_words(rng, (w,), 0.05), torch.zeros(w, dtype=torch.int32),
                  torch.full((w,), BIT31, dtype=torch.int32)):
        want = ba_ops.bitmap_and_any(ent, query, live)
        got = ba_ops.bitmap_and_any(ent.cuda(), query.cuda(), live.cuda())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)


def _table(rng, shape):
    keys = torch.from_numpy(rng.integers(0, 100, shape).astype(np.float32))
    valid = torch.from_numpy(rng.random(shape) < 0.9)
    return keys, valid


@needs_cuda
@pytest.mark.parametrize("p,c", [(1, 50), (63, 50), (65, 7), (300, 50),
                                 (129, 1)])
def test_page_inspect_kernel_equals_plain(p, c):
    rng = np.random.default_rng(p * 100 + c)
    keys, valid = _table(rng, (p, c))
    mask = torch.from_numpy(rng.random(p) < 0.6)
    for lo, hi in ((10.0, 40.0), (50.0, 50.0), (30.0, 20.0), (-1.0, 200.0)):
        want = pi_ops.page_inspect(keys, valid, mask, lo, hi)
        got = pi_ops.page_inspect(keys.cuda(), valid.cuda(), mask.cuda(),
                                  torch.tensor(lo).cuda(), hi)
        torch.cuda.synchronize()
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu(), want[1])


@needs_cuda
@pytest.mark.parametrize("s,p,c,q", [(1, 40, 50, 1), (3, 70, 50, 65),
                                     (1, 5, 7, 3), (2, 300, 50, 64),
                                     (4, 2049, 1, 9), (2, 3, 5, 4100),
                                     (2, 3, 2100, 9), (1, 4, 300, 600)])
def test_page_inspect_many_kernel_equals_plain(s, p, c, q):
    rng = np.random.default_rng(s * 1000 + p + q)
    keys, valid = _table(rng, (s, p, c))
    page_mask = torch.from_numpy(rng.random((s, q, p)) < 0.7)
    lo = rng.integers(0, 100, q).astype(np.float32)
    hi = lo + rng.integers(-5, 30, q).astype(np.float32)   # some empty
    los, his = torch.from_numpy(lo), torch.from_numpy(hi)
    want = pi_ops.page_inspect_many(keys, valid, page_mask, los, his)
    got = pi_ops.page_inspect_many(*(t.cuda() for t in (keys, valid,
                                                        page_mask, los, his)))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# Keys and interval endpoints from one small pool: NaN, both zeros, both
# infinities and a few values, so that keys tie with endpoints and endpoints
# tie with each other; lo == hi and lo > hi come up often.
EDGE_VALUES = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -1.0, 1.0, 2.0,
                        3.0, 3.4e38, -3.4e38], np.float32)


def _edge_batch(seed, q):
    rng = np.random.default_rng(seed)
    los = rng.choice(EDGE_VALUES, q)
    his = np.where(rng.random(q) < 0.3, los, rng.choice(EDGE_VALUES, q))
    return rng, torch.from_numpy(los), torch.from_numpy(his.astype(np.float32))


def _edge_table(rng, shape):
    keys = rng.choice(EDGE_VALUES, shape)
    keys = np.where(rng.random(shape) < 0.3,
                    rng.integers(-2, 5, shape).astype(np.float32), keys)
    valid = rng.random(shape) < 0.85
    return torch.from_numpy(keys), torch.from_numpy(valid)


# The card check is the outer test's (the skipif string is evaluated in this
# module's globals); hypothesis draws inside it.
@needs_cuda
def test_compact_inspect_kernel_equals_plain_on_edge_values():
    @settings(max_examples=30, deadline=None, database=None)
    @given(seed=st.integers(0, 2**32 - 1),
           shape=st.sampled_from([(1, 1, 1, 1), (2, 9, 7, 20), (1, 40, 50, 33),
                                  (3, 12, 33, 64), (1, 6, 100, 5),
                                  (1, 2, 2100, 3)]),
           q=st.sampled_from([1, 2, 15, 16, 64, 65, 127, 130, 1025]))
    def check(seed, shape, q):
        s, p, c, m = shape
        rng, los, his = _edge_batch(seed, q)
        keys, valid = _edge_table(rng, (s, p, c))
        sel = np.sort(rng.integers(0, p + 3, (s, m)), axis=1)   # pads >= P
        sel = torch.from_numpy(sel.astype(np.int32))
        sel_mask = torch.from_numpy(rng.random((s, q, m)) < 0.8)
        want = ci_ops.compact_inspect(keys, valid, sel, sel_mask, los, his)
        got = ci_ops.compact_inspect(*(t.cuda() for t in (keys, valid, sel,
                                                          sel_mask, los,
                                                          his)))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)

    check()


@needs_cuda
def test_page_inspect_many_kernel_equals_plain_on_edge_values():
    @settings(max_examples=30, deadline=None, database=None)
    @given(seed=st.integers(0, 2**32 - 1),
           shape=st.sampled_from([(1, 1, 1), (2, 9, 7), (1, 40, 50),
                                  (3, 33, 33), (1, 6, 100), (1, 2, 2100)]),
           q=st.sampled_from([1, 2, 15, 16, 64, 65, 127, 130, 1025]))
    def check(seed, shape, q):
        s, p, c = shape
        rng, los, his = _edge_batch(seed, q)
        keys, valid = _edge_table(rng, (s, p, c))
        page_mask = torch.from_numpy(rng.random((s, q, p)) < 0.8)
        want = pi_ops.page_inspect_many(keys, valid, page_mask, los, his)
        got = pi_ops.page_inspect_many(*(t.cuda() for t in (keys, valid,
                                                            page_mask, los,
                                                            his)))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)

    check()


def _at_offset(t, off):
    """``t`` on the card, ``off`` elements past a 16 B aligned base (a slice
    of a larger tensor, as a shard's view is)."""
    big = torch.zeros(t.numel() + off, dtype=t.dtype, device="cuda")
    view = big[off:].view(t.shape)
    view.copy_(t.cuda())
    assert big.data_ptr() % 16 == 0
    return view


def _page_inspect_on_card(keys, valid, mask, lo, hi, offsets=(0, 0, 0)):
    """The kernel with keys, valid and the qual output each at its own
    offset from an aligned base (the wrapper allocates qual aligned, so the
    binding is called directly)."""
    p, c = keys.shape
    k = _at_offset(keys, offsets[0])
    v = _at_offset(valid, offsets[1])
    qual = _at_offset(torch.zeros((p, c), dtype=torch.bool), offsets[2])
    counts = torch.full((p,), -1, dtype=torch.int32, device="cuda")
    interval = torch.tensor([lo, hi], dtype=torch.float32, device="cuda")
    pi_kernel.launch(k, v, mask.cuda(), interval, qual, counts)
    torch.cuda.synchronize()
    return qual.cpu(), counts.cpu()


# Page widths at and around the kernel's 16-tuple runs (a run spans up to 16
# pages at C = 1, two pages from C = 16 on, and a 64-page tile takes several
# rounds of a block's runs at C = 2100); P off the 64-page tile and P = 1.
@needs_cuda
@pytest.mark.parametrize("c", [1, 7, 15, 16, 17, 50, 300, 2100])
@pytest.mark.parametrize("p", [1, 63, 130])
def test_page_inspect_kernel_at_run_edges(p, c):
    rng = np.random.default_rng(p * 10000 + c)
    keys, valid = _edge_table(rng, (p, c))
    for mask in (torch.from_numpy(rng.random(p) < 0.6),
                 torch.ones(p, dtype=torch.bool),
                 torch.zeros(p, dtype=torch.bool)):
        for lo, hi in ((1.0, 3.0), (2.0, 2.0), (3.0, 1.0), (-np.inf, np.inf),
                       (-0.0, 0.0), (np.nan, 1.0), (-3.4e38, 3.4e38)):
            want = pi_ops.page_inspect(keys, valid, mask, lo, hi)
            for offsets in ((0, 0, 0), (1, 2, 3), (3, 1, 0), (2, 0, 1)):
                got = _page_inspect_on_card(keys, valid, mask, lo, hi,
                                            offsets)
                assert torch.equal(got[0], want[0]), offsets
                assert torch.equal(got[1], want[1]), offsets


@needs_cuda
def test_page_inspect_kernel_equals_plain_on_drawn_edges():
    @settings(max_examples=40, deadline=None, database=None)
    @given(seed=st.integers(0, 2**32 - 1), p=st.integers(1, 200),
           c=st.sampled_from([1, 2, 7, 15, 16, 17, 31, 50, 64, 300]),
           offsets=st.tuples(*[st.integers(0, 3)] * 3),
           lo=st.sampled_from(list(EDGE_VALUES)),
           hi=st.sampled_from(list(EDGE_VALUES)),
           density=st.sampled_from([0.0, 0.3, 1.0]))
    def check(seed, p, c, offsets, lo, hi, density):
        rng = np.random.default_rng(seed)
        keys, valid = _edge_table(rng, (p, c))
        mask = torch.from_numpy(rng.random(p) < density)
        want = pi_ops.page_inspect(keys, valid, mask, lo, hi)
        got = _page_inspect_on_card(keys, valid, mask, lo, hi, offsets)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1], want[1])

    check()


def _bounds(kind, rng, h):
    b = np.cumsum(rng.random(h + 1) + 0.01).astype(np.float32)
    if kind == "tied":                    # runs of equal bounds
        b = np.sort(rng.integers(0, max(2, h // 8), h + 1)).astype(np.float32)
    elif kind == "equal":                 # a zero span
        b = np.full(h + 1, 2.0, np.float32)
    elif kind == "infinite ends":
        b[0], b[-1] = -np.inf, np.inf
    elif kind == "signed zeros":          # -0.0 and +0.0 among the bounds
        b = np.sort(np.concatenate([rng.uniform(-3, 3, h - 1),
                                    [-0.0, 0.0]])).astype(np.float32)
    return b


# N around the 4- and 2-value vectors, N of the vector launch without the
# rank table (4096 values up to 16 a resident thread: an insert batch, one
# vacuum's re-probed pages) and the launch that takes the rank table (the
# large odd N), values 1-3 elements past an aligned base (heads, tails, and
# the 8-mod-16 base of an odd shard's view), NaN, +-0, +-inf and values
# equal to bounds.
@needs_cuda
@pytest.mark.parametrize("kind", ["increasing", "tied", "equal",
                                  "infinite ends", "signed zeros"])
@pytest.mark.parametrize("h", [1, 7, 64, 400, 12287])
def test_bucketize_kernel_at_edges(h, kind):
    rng = np.random.default_rng(h)
    b = _bounds(kind, rng, h)
    bounds = torch.from_numpy(b)
    fin = b[np.isfinite(b)]
    pool = np.concatenate([EDGE_VALUES, b]).astype(np.float32)
    for n in (1, 3, 4, 5, 127, 128, 129, 4096, 59_986, 290_001,
              4_500_001):
        v = rng.choice(pool, n)
        if n > 1000 and fin.size:
            v[::2] = rng.uniform(fin[0] - 1, fin[-1] + 1, v[::2].size)
        vals = torch.from_numpy(v.astype(np.float32))
        want = bk_ops.bucketize_ref(vals.cuda(), bounds.cuda(), h).cpu()
        for off in (0, 1, 2, 3):
            got = bk_ops.bucketize_values(_at_offset(vals, off),
                                          bounds.cuda(), h)
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (n, off)


@needs_cuda
def test_bucketize_kernel_equals_plain_on_drawn_edges():
    @settings(max_examples=40, deadline=None, database=None)
    @given(seed=st.integers(0, 2**32 - 1),
           n=st.integers(1, 3000) | st.integers(4096, 70_000),
           off=st.integers(0, 3), h=st.sampled_from([1, 2, 7, 64, 400]),
           kind=st.sampled_from(["increasing", "tied", "equal",
                                 "infinite ends", "signed zeros"]))
    def check(seed, n, off, h, kind):
        rng = np.random.default_rng(seed)
        b = _bounds(kind, rng, h)
        pool = np.concatenate([EDGE_VALUES, b, rng.uniform(-5, 400, 20)])
        vals = torch.from_numpy(rng.choice(pool, n).astype(np.float32))
        want = bk_ops.bucketize_values(vals, torch.from_numpy(b), h)
        got = bk_ops.bucketize_values(_at_offset(vals, off),
                                      torch.from_numpy(b).cuda(), h)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)

    check()


# NaN values (both signs, other payloads) among +-0, +-inf and values equal
# to bounds, with the nan_last flag set (the core's NaN -> H-1) and clear
# (the TPU kernel's formula, NaN -> 0), on the vector widths, the vector
# launch without the rank table (an insert batch's N) and the table
@needs_cuda
@pytest.mark.parametrize("nan_last", [False, True])
@pytest.mark.parametrize("kind", ["increasing", "tied", "equal",
                                  "infinite ends", "signed zeros"])
def test_bucketize_kernel_nan_last_equals_plain(kind, nan_last):
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                    np.uint32).view(np.float32)
    for h in (1, 16, 400):
        rng = np.random.default_rng(h)
        b = _bounds(kind, rng, h)
        pool = np.concatenate([nans, EDGE_VALUES, b]).astype(np.float32)
        bounds = torch.from_numpy(b)
        for n in (1, 5, 129, 4096, 59_986, 4_500_001):
            vals = torch.from_numpy(rng.choice(pool, n).astype(np.float32))
            want = bk_ops.bucketize_ref(vals.cuda(), bounds.cuda(), h,
                                        nan_last).cpu()
            assert (want[vals.isnan()] == (h - 1 if nan_last else 0)).all()
            for off in (0, 1, 2):
                got = bk_ops.bucketize_values(_at_offset(vals, off),
                                              bounds.cuda(), h, nan_last)
                torch.cuda.synchronize()
                assert torch.equal(got.cpu(), want), (h, n, off)


# The rows entry (predicate conversion's launch): S rows of bounds of mixed
# kinds over one set of values, NaN among them, with the nan_last flag set
# and clear; N of a batch's 2Q endpoints, N at the vector widths where every
# out row keeps the values' offset (N % 4 == 0, N % 2 == 0) and where it
# does not (odd N), and the rank table's launch; row s against
# bucketize_ref under bounds[s] alone, in one launch.
@needs_cuda
@pytest.mark.parametrize("nan_last", [False, True])
@pytest.mark.parametrize("s", [1, 4])
def test_bucketize_rows_kernel_equals_plain_row_by_row(s, nan_last):
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                    np.uint32).view(np.float32)
    kinds = ["increasing", "tied", "equal", "infinite ends", "signed zeros"]
    for h in (1, 16, 400):
        rng = np.random.default_rng(h + s)
        b = np.stack([_bounds(kinds[(r + h) % 5], rng, h) for r in range(s)])
        pool = np.concatenate([nans, EDGE_VALUES, b.ravel()]).astype(
            np.float32)
        bounds = torch.from_numpy(b).cuda()
        for n in (1, 5, 128, 4097, 4098, 8192, 4_500_000, 4_500_001):
            vals = torch.from_numpy(rng.choice(pool, n).astype(np.float32))
            want = torch.stack([bk_ops.bucketize_ref(vals.cuda(), bounds[r],
                                                     h, nan_last)
                                for r in range(s)]).cpu()
            for off in (0, 1, 2):
                before = bk_kernel.KERNEL.launches
                got = bk_ops.bucketize_rows(_at_offset(vals, off), bounds, h,
                                            nan_last)
                torch.cuda.synchronize()
                assert bk_kernel.KERNEL.launches == before + 1
                assert torch.equal(got.cpu(), want), (h, n, off)


def _conversion_pair(num_shards=4):
    vals = np.random.default_rng(5).integers(0, 2555, 40_000).astype(
        np.float32)
    return [ShardedHippoIndex.create(PagedTable.from_values(vals, 50),
                                     num_shards=num_shards, device=dev)
            for dev in ("cuda", "cpu")]


def _same_bits(got, want):
    """Equal bit for bit (a NaN endpoint equals itself)."""
    return torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


def _conversion_batch(seed, q=64):
    rng = np.random.default_rng(seed)
    preds = [Predicate.between(float(lo), float(lo + w)) for lo, w in
             zip(rng.integers(0, 2500, q), rng.choice([0, 29, 89, 364], q))]
    preds[:4] = [Predicate.between(9.0, 1.0), Predicate(),
                 Predicate.between(float("nan"), 5.0), Predicate.greater(2000)]
    return preds


@needs_cuda
def test_convert_stage_makes_no_host_sync():
    """``hippo.index.convert`` of ``search_compact_batch`` (the
    ``_query_bitmaps`` call) on a card index runs under
    ``torch.cuda.set_sync_debug_mode("error")``, and equals the CPU's."""
    card, cpu = _conversion_pair()
    preds = _conversion_batch(1)
    card._query_bitmaps(preds)          # builds the library, pins a block
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = card._query_bitmaps(preds)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, w in zip(got, cpu._query_bitmaps(preds)):
        assert _same_bits(g, w)


@needs_cuda
def test_back_to_back_batches_keep_their_own_counts():
    """Two compact batches with different predicates enqueued back to back
    behind ~0.1 s of device work each return their own exact counts: the
    first batch's page-locked upload is not reused by the second while its
    copy waits on the stream."""
    card, cpu = _conversion_pair()
    batches = [_conversion_batch(2), _conversion_batch(3)]
    cap = card.gather_cap
    card.search_compact_batch(batches[0], max_selected=cap)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    qbms = [card._query_bitmaps(b) for b in batches]
    torch.cuda._sleep(200_000_000)
    got = [card.search_compact_batch(b, max_selected=cap, top_k=8)
           for b in batches]
    for b, g, q in zip(batches, got, qbms):
        w = cpu.search_compact_batch(b, max_selected=cap, top_k=8)
        for f in w._fields:
            assert torch.equal(getattr(g, f).cpu(), getattr(w, f)), f
        for gq, wq in zip(q, cpu._query_bitmaps(b)):
            assert _same_bits(gq, wq)


# The words entry (predicate conversion's launch): the (S, Q, W) query
# bitmaps of Q intervals whose endpoints are NaN, +-0, +-inf, +-3.4e38, on
# and beside the bounds, lo > hi among them, a tenth marked empty, under S
# bounds rows equal or distinct; at one word (H = 32), a partial last word
# (H = 100) and H = 400; Q of none, one, a batch, one block's 256 and past
# it, and at H = 400 past every resident block of a row (the strided loop);
# against the plain path bit for bit, one launch each.
@needs_cuda
@pytest.mark.parametrize("rows", ["equal", "distinct"])
@pytest.mark.parametrize("nan_last", [False, True])
@pytest.mark.parametrize("s", [1, 4])
def test_bucketize_rows_words_kernel_equals_plain(s, nan_last, rows):
    kinds = ["increasing", "tied", "equal", "infinite ends", "signed zeros"]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    strided = sms * 8 // s * 256 + 1
    bit31 = False
    for h in (32, 100, 400):
        rng = np.random.default_rng(h + s)
        b = np.stack([_bounds(kinds[(r + h) % 5] if rows == "distinct"
                              else "increasing", rng, h) for r in range(s)])
        if rows == "equal":
            b = np.stack([b[0]] * s)
        pool = np.concatenate([EDGE_VALUES, b.ravel(), b.ravel() + 0.005])
        bounds = torch.from_numpy(b)
        for q in (0, 1, 64, 256, 257, 1000) + ((strided,) if h == 400
                                               else ()):
            los = rng.choice(pool, q).astype(np.float32)
            his = np.where(rng.random(q) < 0.5,
                           los + rng.choice([0.0, 1.0, 30.0], q),
                           rng.choice(pool, q)).astype(np.float32)
            args = [torch.from_numpy(x) for x in
                    (los, his, rng.random(q) < 0.9)]
            want = bk_ops.bucketize_rows_words_ref(*args, bounds, h, nan_last)
            before = (bk_kernel.KERNEL.launches,
                      bk_kernel.launch_rows_words.launches)
            got = bk_ops.bucketize_rows_words(*(a.cuda() for a in args),
                                              bounds.cuda(), h, nan_last)
            torch.cuda.synchronize()
            n = int(q > 0)
            assert (bk_kernel.KERNEL.launches,
                    bk_kernel.launch_rows_words.launches) == (
                        before[0] + n, before[1] + n)
            assert got.shape == (s, q, (h + 31) // 32)
            assert torch.equal(got.cpu(), want), (h, q)
            bit31 |= bool((want < 0).any())
    assert bit31


@needs_cuda
def test_bucketize_rows_words_refuses_bounds_past_shared_memory():
    """A bounds row past what one block's shared memory holds is refused
    before any launch; the largest row that fits (above the 48 KB a block
    has without asking) runs and equals the plain path."""
    nb = bk_ops._MAX_BOUNDS + 1
    bounds = torch.arange(nb, dtype=torch.float32, device="cuda")[None]
    los = torch.tensor([-1.0, 5.5, 100.0, 9000.0, 31.0], device="cuda")
    his = los + torch.tensor([0.0, 300.0, 40.0, 5000.0, 1.0], device="cuda")
    nonempty = torch.ones(5, dtype=torch.bool, device="cuda")
    before = bk_kernel.KERNEL.launches
    with pytest.raises(ValueError, match="shared memory"):
        bk_ops.bucketize_rows_words(los, his, nonempty, bounds, nb - 1)
    assert bk_kernel.KERNEL.launches == before
    fits = bounds[:, :-1].contiguous()
    got = bk_ops.bucketize_rows_words(los, his, nonempty, fits, nb - 2)
    want = bk_ops.bucketize_rows_words_ref(los.cpu(), his.cpu(),
                                           nonempty.cpu(), fits.cpu(), nb - 2)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@needs_cuda
def test_query_bitmaps_is_one_launch_of_the_words_entry():
    """One ``_query_bitmaps`` call (a batch's ``hippo.index.convert``) on a
    card index adds 1 to the words entry's count and 1 to the bucket
    probe's, and its device trace holds one kernel and one host-to-device
    copy; the words equal the CPU's."""
    card, cpu = _conversion_pair()
    preds = _conversion_batch(4)
    card._query_bitmaps(preds)          # builds the library, pins a block
    torch.cuda.synchronize()
    before = (bk_kernel.KERNEL.launches, bk_kernel.launch_rows_words.launches)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = card._query_bitmaps(preds)
        torch.cuda.synchronize()
    assert (bk_kernel.KERNEL.launches,
            bk_kernel.launch_rows_words.launches) == (before[0] + 1,
                                                      before[1] + 1)
    dev = [e.name for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [n for n in dev if n.startswith("Memcpy")]
    kernels = [n for n in dev if not n.startswith("Memcpy")]
    assert len(copies) == 1 and "HtoD" in copies[0], dev
    assert len(kernels) == 1 and "bucketize_words_kernel" in kernels[0], dev
    for g, w in zip(got, cpu._query_bitmaps(preds)):
        assert _same_bits(g, w)


@needs_cuda
def test_engines_convert_on_card_through_the_words_entry(monkeypatch):
    """On the card no engine packs bits with ``range_mask`` or
    ``from_bool``; on the compact engine (the main path, with its widened
    slabs and fallbacks) the words entry's count equals the
    ``_query_bitmaps`` calls; every answer equals the CPU's."""
    from repro_torch.core import bitmap as bm
    card, cpu = _conversion_pair()      # the build packs with from_bool
    for name in ("range_mask", "from_bool"):
        def guarded(*a, _fn=getattr(bm, name), _name=name, **k):
            assert not any(isinstance(x, torch.Tensor) and x.is_cuda
                           for x in a), f"{_name} on a card tensor"
            return _fn(*a, **k)
        monkeypatch.setattr(bm, name, guarded)
    calls = []
    real = card._query_bitmaps

    def counted(preds):
        calls.append(len(preds))
        return real(preds)
    monkeypatch.setattr(card, "_query_bitmaps", counted)
    preds = [p for seed in range(5, 9) for p in _conversion_batch(seed)]
    out = {}
    for idx in (card, cpu):
        runs = []
        for kw in ({"top_k": 8, "compact_bucket": 4}, {"mode": "dense"},
                   {"mode": "dense", "sharded": False}):
            before = bk_kernel.launch_rows_words.launches
            del calls[:]
            eng = QueryEngine(idx, batch=32, **kw)
            tickets = [eng.submit(p) for p in preds]
            eng.drain()
            if idx is card and "mode" not in kw:
                assert len(calls) >= len(preds) // 32
                assert (bk_kernel.launch_rows_words.launches - before
                        == len(calls))
            runs.append([(t.count, t.pages_inspected, t.entries_matched)
                         for t in tickets])
        out[idx.device.type] = runs
    assert out["cuda"] == out["cpu"]


def _maintenance_stream(idx, rng):
    """Eager inserts, a batch across the partial page and new pages, a
    delete and its vacuum; returns what a caller can observe."""
    for v in rng.integers(0, 2555, 40):
        idx.insert(float(v))
    idx.insert_batch(rng.integers(0, 2555, 3000).astype(np.float32))
    deleted = idx.table.delete_where(100.0, 160.0)
    resummarized = idx.vacuum()
    st = getattr(idx.state, "shards", idx.state)
    fields = {f: getattr(st, f).cpu().numpy().tolist() for f in st._fields}
    if hasattr(idx.state, "summaries"):
        fields["summaries"] = idx.state.summaries.cpu().numpy().tolist()
    return fields, (deleted, resummarized, dict(vars(idx.counters)),
                    idx.table.num_pages, idx.table.fill)


@needs_cuda
@pytest.mark.parametrize("relocate", [True, False])
def test_maintenance_on_card_equals_maintenance_on_cpu(relocate):
    # the same stream on the card and on the CPU ends in equal state and
    # counts, sharded and unsharded; after it the unsharded index serves
    # search (F, E) and a dense batch (D, batched E), the sharded one the
    # compact engine (A, B)
    vals = np.random.default_rng(5).integers(0, 2555, 40_003).astype(
        np.float32)
    preds = [Predicate.between(float(lo), float(lo + w)) for lo, w in
             zip(np.random.default_rng(6).integers(0, 2400, 40),
                 [0, 9, 99] * 14)]
    out = {}
    for dev in ("cpu", "cuda"):
        runs = []
        for make in (lambda t: HippoIndex.create(
                         t, device=dev, max_slots=8000,
                         relocate_on_update=relocate),
                     lambda t: ShardedHippoIndex.create(
                         t, num_shards=3, device=dev, max_slots=8000,
                         relocate_on_update=relocate)):
            idx = make(PagedTable.from_values(vals, 50, spare_pages=70))
            runs.append(_maintenance_stream(idx, np.random.default_rng(7)))
            if isinstance(idx, HippoIndex):
                res = idx.search(preds[2])
                runs.append((int(res.count), int(res.pages_inspected),
                             res.qualified.cpu().numpy().tolist()))
                eng = QueryEngine(idx, batch=16, mode="dense")
            else:
                eng = QueryEngine(idx, batch=16, top_k=4, compact_bucket=4)
            tickets = [eng.submit(p) for p in preds]
            eng.drain()
            runs.append([(t.count, t.pages_inspected, t.entries_matched)
                         for t in tickets])
        out[dev] = runs
    assert out["cuda"] == out["cpu"]


@needs_cuda
def test_engine_on_card_equals_engine_on_cpu():
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2555, 40_000).astype(np.float32)
    preds = [Predicate.between(float(lo), float(lo + w))
             for lo, w in zip(rng.integers(0, 2400, 90), [0, 9, 99] * 30)]
    out = {}
    for dev in ("cpu", "cuda"):
        idx = ShardedHippoIndex.create(PagedTable.from_values(vals, 50),
                                       num_shards=3, device=dev)
        eng = QueryEngine(idx, batch=32, top_k=8, compact_bucket=4)
        tickets = [eng.submit(p) for p in preds]
        eng.drain()
        out[dev] = ([(t.count, t.pages_inspected, t.entries_matched,
                      t.row_ids.tolist()) for t in tickets],
                    (eng.stats.compact_fallbacks, eng.stats.gather_union_pages,
                     eng.stats.gather_slab_pages))
    assert out["cuda"] == out["cpu"]


@needs_cuda
def test_dense_engines_on_card_equal_engines_on_cpu():
    rng = np.random.default_rng(4)
    vals = np.sort(rng.integers(0, 2555, 40_000)).astype(np.float32)
    preds = [Predicate.between(float(lo), float(lo + w))
             for lo, w in zip(rng.integers(0, 2400, 90), [0, 9, 99] * 30)]
    out = {}
    for dev in ("cpu", "cuda"):
        hidx = HippoIndex.create(PagedTable.from_values(vals, 50), device=dev)
        sidx = ShardedHippoIndex.create(PagedTable.from_values(vals, 50),
                                        num_shards=4, device=dev)
        runs = []
        for idx, kw in ((hidx, {}), (sidx, {}), (sidx, {"sharded": False})):
            eng = QueryEngine(idx, batch=32, mode="dense", **kw)
            tickets = [eng.submit(p) for p in preds]
            eng.drain()
            runs.append(([(t.count, t.pages_inspected, t.entries_matched)
                          for t in tickets],
                         (eng.stats.shard_dispatches, eng.stats.shards_pruned,
                          eng.stats.slots_filled, eng.stats.pad_slots)))
        res = hidx.search(preds[1])
        runs.append((int(res.count), res.qualified.cpu().numpy().tolist(),
                     res.page_mask.cpu().numpy().tolist()))
        out[dev] = runs
    assert out["cuda"] == out["cpu"]
    assert out["cpu"][1][1][1] > 0          # the routed run pruned shards


def _writer_stream(dev: str, policy: str) -> list:
    """A writer-backed stream on ``dev``: drifting staged writes, compact
    and routed batches (some mid-remap, with the overlay), a delete, the
    drained vacuums; returns every result and counter."""
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 2555, 30_000).astype(np.float32)
    sidx = ShardedHippoIndex.create(PagedTable.from_values(vals, 50),
                                    num_shards=4, device=dev)
    eng = QueryEngine(sidx, batch=32, top_k=8, drain_policy=policy)
    routed = QueryEngine(sidx, batch=32, mode="dense", drain_policy="manual",
                         writer=eng.writer)
    out = []
    for r in range(6):
        for v in rng.integers(2555, 2645, 300):
            eng.write(float(v))
        preds = [Predicate.between(float(lo), float(lo + w))
                 for lo, w in zip(rng.integers(2300, 2645, 40), [0, 9, 99] * 14)]
        for e in (eng, routed):
            tickets = [e.submit(p) for p in preds]
            e.drain()
            out.append([(t.count, t.pages_inspected, t.entries_matched,
                         None if t.row_ids is None else t.row_ids.tolist())
                        for t in tickets])
        if r == 3:
            out.append(eng.delete(100.0, 110.0))
    out.append(eng.flush())
    st = eng.stats
    out.append((st.drains, st.drained_rows, st.resummarizes, st.writes,
                st.deletes, st.edge_overflow_ratio, st.peak_queue_depth,
                sidx.bounds_epochs.tolist()))
    out.append([f.cpu().numpy().tolist() for f in sidx.state.shards])
    return out


@needs_cuda
@pytest.mark.parametrize("policy", ["between_batches", "on_depth", "manual"])
def test_writer_engine_on_card_equals_cpu(policy):
    assert _writer_stream("cuda", policy) == _writer_stream("cpu", policy)


@needs_cuda
def test_insert_drain_patch_makes_no_host_sync(monkeypatch):
    """An insert drain's slab patch (``PagedTable.sync_slab_view``) on a
    card index runs under ``torch.cuda.set_sync_debug_mode("error")``: one
    page-locked upload a tensor, no pageable copy. The patched view equals
    a whole upload of the host table, and the counts the CPU's."""
    rng = np.random.default_rng(10)
    vals = rng.integers(0, 2555, 40_037).astype(np.float32)
    writes = rng.integers(0, 2555, (4, 120)).astype(np.float32)
    preds = [Predicate.between(float(lo), float(lo + 30))
             for lo in range(0, 2555, 100)]
    patch, patched = PagedTable.sync_slab_view, []

    def strict(self):
        if not patched:                     # the first pins its blocks
            patched.append(patch(self))
            return patched[-1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            patched.append(patch(self))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return patched[-1]

    monkeypatch.setattr(PagedTable, "sync_slab_view", strict)
    counts = {}
    for dev in ("cuda", "cpu"):
        sidx = ShardedHippoIndex.create(PagedTable.from_values(vals, 50),
                                        num_shards=4, device=dev)
        eng = QueryEngine(sidx, batch=32, drain_policy="manual",
                          auto_resummarize=False)
        table = sidx.table
        counts[dev] = [eng.run_all(preds).tolist()]     # a fresh slab view
        slabs = table._dev_shard
        for row in writes:
            for v in row:
                eng.write(float(v))
            eng.writer.drain(1)
            assert table._dev_shard is slabs and not slabs.pending
            counts[dev].append(eng.run_all(preds).tolist())
        for host, view in ((table.keys, slabs.keys),
                           (table.valid, slabs.valid)):
            whole = torch.zeros(view.shape, dtype=view.dtype).view(-1, 50)
            whole[: table.num_pages] = torch.from_numpy(
                host[: table.num_pages])
            assert torch.equal(view.cpu().view(-1, 50), whole)
    assert len(patched) == 2 * len(writes) and all(patched)
    assert counts["cuda"] == counts["cpu"]


@needs_cuda
def test_learned_index_on_card_equals_cpu():
    rng = np.random.default_rng(8)
    vals = rng.integers(1, 51, 40_000).astype(np.float32)
    preds = [Predicate.between(float(lo), float(lo + w))
             for lo, w in zip(rng.integers(1, 27, 60), [0, 4, 23] * 20)]
    writes = rng.integers(1, 51, 500)
    out = {}
    for dev in ("cpu", "cuda"):
        sidx = ShardedHippoIndex.create(PagedTable.from_values(vals, 50),
                                        num_shards=4, summary="learned",
                                        device=dev)
        runs = [sidx.state.shards.bounds.cpu().numpy().tolist(),
                sidx.summary_models[0].knots_x.tolist()]
        eng = QueryEngine(sidx, batch=32, top_k=8)
        for mode_eng in (eng, QueryEngine(sidx, batch=32, mode="dense",
                                          drain_policy="manual",
                                          writer=eng.writer)):
            tickets = [mode_eng.submit(p) for p in preds]
            mode_eng.drain()
            runs.append([(t.count, t.pages_inspected) for t in tickets])
        for v in writes:
            eng.write(float(v))
        runs.append(eng.resummarize())
        runs.append(eng.stats.learned_refits)
        runs.append(sidx.state.shards.bounds.cpu().numpy().tolist())
        runs.append(eng.run_all(preds).tolist())
        out[dev] = runs
    assert out["cuda"] == out["cpu"]


def _durable_stream(dev: str, root) -> list:
    """A durable engine on ``dev``: journaled writes, a delete, drains that
    commit deltas, then a crash before a swap and ``QueryEngine.recover``
    on the same device; returns every count, the directory's files and
    the recovered state."""
    from repro_torch.runtime import faultinject as fi
    rng = np.random.default_rng(9)
    vals = rng.integers(0, 2555, 30_000).astype(np.float32)
    sidx = ShardedHippoIndex.create(PagedTable.from_values(vals, 50),
                                    num_shards=4, device=dev)
    kw = dict(batch=32, top_k=8, wal_sync=False)
    eng = QueryEngine(sidx, storage_dir=root, **kw)
    preds = [Predicate.between(float(lo), float(lo + w)) for lo, w in
             zip(rng.integers(0, 2645, 40), [0, 9, 99] * 14)]
    out = []
    for r in range(4):
        for v in rng.integers(2300, 2645, 300):
            eng.write(float(v))
        if r == 1:
            out.append(eng.delete(100.0, 110.0))
        out.append(eng.run_all(preds).tolist())
    for v in rng.integers(0, 2645, 200):
        eng.write(float(v))
    fi.crash_points.reset()
    fi.crash_points.arm("drain.pre_swap")
    try:
        with pytest.raises(fi.InjectedCrash):
            eng.flush()
    finally:
        fi.crash_points.reset()
    eng.close()
    del eng, sidx
    eng = QueryEngine.recover(root, device=dev, **kw)
    assert eng.index.device.type == dev
    out.append(eng.writer.staged_rows)
    out.append(eng.run_all(preds).tolist())
    eng.flush()
    out.append(eng.run_all(preds).tolist())
    eng.close()
    out.append(sorted(p.name for p in root.iterdir()))
    out.append([f.cpu().numpy().tolist() for f in eng.index.state.shards])
    loaded = ShardedHippoIndex.load(root, device=dev)
    out.append(QueryEngine(loaded, batch=32, drain_policy="manual")
               .run_all(preds).tolist())
    return out


@needs_cuda
def test_durable_engine_on_card_equals_cpu(tmp_path):
    got = _durable_stream("cuda", tmp_path / "cuda")
    want = _durable_stream("cpu", tmp_path / "cpu")
    assert got == want
    assert (tmp_path / "cuda" / "snap_2" / "index.bin").read_bytes() == \
        (tmp_path / "cpu" / "snap_2" / "index.bin").read_bytes()


@needs_cuda
def test_save_and_load_on_card(tmp_path):
    vals = np.random.default_rng(10).integers(0, 2555, 40_000).astype(
        np.float32)
    preds = [Predicate.between(float(lo), float(lo + w)) for lo, w in
             zip(np.random.default_rng(11).integers(0, 2400, 30),
                 [0, 9, 99] * 10)]
    sidx = ShardedHippoIndex.create(PagedTable.from_values(vals, 50),
                                    num_shards=3)
    sidx.save(tmp_path)
    back = ShardedHippoIndex.load(tmp_path)
    assert back.device.type == "cuda"
    for a, b in zip(sidx.state, back.state):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(QueryEngine(sidx, batch=16).run_all(preds),
                          QueryEngine(back, batch=16).run_all(preds))
    on_cpu = ShardedHippoIndex.load(tmp_path, device="cpu")
    assert all(torch.equal(x.cpu(), y) for x, y in
               zip(back.state.shards, on_cpu.state.shards))


def _btree_stream(dev: str) -> list:
    """A B+-tree on ``dev`` after bulk load, inserts (leaf, internal and root
    splits), deletes and searches; returns every answer, the counters, the
    structure and the leaf pools."""
    rng = np.random.default_rng(12)
    vals = rng.integers(0, 300, 20_000).astype(np.float32)
    vals[::97] = -0.0
    vals[::131] = np.nan
    tree = BPlusTree.bulk_load(vals, 50, fanout=16, device=dev)
    out = []
    for i in range(1500):
        k = float(rng.integers(-5, 310)) + (0.5 if i % 7 == 0 else 0.0)
        tree.insert(k, 1_000_000 + i)
        if i % 5 == 0:
            out.append(tree.delete(float(rng.integers(0, 300))))
        if i % 50 == 0:
            lo = float(rng.integers(0, 300)) - 0.25
            out.append(tree.range_search(lo, lo + 9).cpu().tolist())
            out.append(tree.count_range(lo, lo + 9))
    out.append((tree.io.node_reads, tree.io.node_writes,
                tree.io.node_splits, tree.nbytes(), tree.num_keys,
                tree.num_nodes()))
    st = tree.structure()
    out.append([[k.view(np.int64).tolist() for k in lvl]
                for lvl in st["internal"]])
    out.append([(k.view(np.int64).tolist(), t.tolist())
                for k, t in st["leaves"]])
    n = tree.num_nodes()[0]
    out.append(tree._lkeys[:n].cpu().numpy().view(np.int64).tolist())
    out.append(tree._ltids[:n].cpu().numpy().tolist())
    return out


@needs_cuda
def test_btree_on_card_equals_cpu():
    assert _btree_stream("cuda") == _btree_stream("cpu")


@needs_cuda
def test_btree_stable_order_on_card_equals_numpy():
    """The bulk load's stable order against ``np.argsort(kind="stable")``
    with ties, -0.0/+0.0 mixed and NaN (both signs) on the card."""
    from repro_torch.core.baselines.btree import _stable_order
    rng = np.random.default_rng(13)
    base = np.array([0.0, -0.0, np.nan, -np.nan, 1.0, -1.0, np.inf, -np.inf,
                     3.5], np.float32)
    for n in (9, 1000, 300_000):
        vals = rng.choice(base, n)
        got = _stable_order(torch.from_numpy(vals).cuda()).cpu().numpy()
        assert np.array_equal(got, np.argsort(vals, kind="stable"))


@needs_cuda
def test_minmax_and_fullscan_on_card_equal_cpu():
    rng = np.random.default_rng(14)
    vals = rng.uniform(0, 1000, 50_000).astype(np.float32)
    vals[::1001] = np.nan
    table = PagedTable.from_values(vals, 50)
    table.delete_where(100.0, 120.0)
    out = {}
    for dev in ("cpu", "cuda"):
        keys = table.device_keys(device=dev)
        valid = table.device_valid(device=dev)
        runs = []
        for ppr in (1, 3, 128):
            mm = MinMaxIndex.build(keys, valid, ppr)
            runs.append((mm.mins.cpu().numpy().view(np.int32).tolist(),
                         mm.maxs.cpu().numpy().view(np.int32).tolist()))
            for lo in (0.1, 99.5, 1277.5000001, 500.0):
                runs.append([int(x) for x in mm.search(keys, valid, lo,
                                                       lo + 3.3)])
        for lo in (0.1, 99.5, 1277.5000001, 500.0):
            runs.append([int(x) for x in FullScan.search(keys, valid, lo,
                                                         lo + 3.3)])
        out[dev] = runs
    assert out["cuda"] == out["cpu"]


@needs_cuda
def test_kvindex_on_card_equals_cpu_through_the_bucket_probe():
    from repro_torch import kernels as K
    from repro_torch.core import kvindex as kv
    rng = np.random.default_rng(15)
    centers = rng.standard_normal((64, 1, 4, 64)).astype(np.float32)
    keys = (np.repeat(centers, 64, axis=0).reshape(1, 4096, 4, 64)
            + 0.3 * rng.standard_normal((1, 4096, 4, 64))).astype(np.float32)
    values = rng.standard_normal((1, 4096, 4, 64)).astype(np.float32)
    q = rng.standard_normal((1, 4, 64)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = kv.KVIndexConfig(num_channels=8, resolution=16)
        K.reset_launch_counts()
        idx = kv.build_kv_index(cfg, keys, device=dev)
        launches = K.launch_counts()["bucketize"]
        assert launches == (8 if dev == "cuda" else 0)
        runs = [idx.channels.cpu().tolist(),
                idx.bounds.cpu().numpy().view(np.int32).tolist(),
                idx.bitmaps.cpu().tolist()]
        tq = torch.from_numpy(q).to(dev)
        for mc in (1, 2, 4):
            runs.append(kv.query_page_mask(idx, tq, mc).cpu().tolist())
        mask = kv.query_page_mask(idx, tq, 2)
        o, m = kv.hippo_kv_attention(tq, torch.from_numpy(keys).to(dev),
                                     torch.from_numpy(values).to(dev),
                                     mask, 64)
        out[dev] = (runs, o.cpu(), m.cpu())
    assert out["cuda"][0] == out["cpu"][0]
    torch.testing.assert_close(out["cuda"][1], out["cpu"][1], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=1e-5,
                               atol=1e-6)


MODEL_ARCHS = ["llama4-maverick-400b-a17b", "qwen2-moe-a2.7b", "qwen2-vl-7b",
               "musicgen-large", "recurrentgemma-9b", "yi-6b", "stablelm-3b",
               "qwen2.5-3b", "smollm-360m", "rwkv6-3b"]


@needs_cuda
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_model_on_card_equals_model_on_cpu(arch):
    """The reduced config (float32, TF32 off) through forward, prefill and
    three decode steps on the card against the same weights on the CPU,
    within 1e-4."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import serve as ts
    from repro_torch.models import transformer as tt
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).reduced()
    if cfg.num_experts:
        cfg = replace(cfg, capacity_factor=8.0)
    cpu = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu").to(
        "cuda")
    rng = np.random.default_rng(1)
    b, s = 2, 12
    if cfg.frontend == "tokens":
        inputs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    else:
        inputs = torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))
    pos = torch.arange(s)[None].expand(b, s)
    tol = dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(
        tt.forward(card, inputs.cuda(), pos.cuda()).cpu(),
        tt.forward(cpu, inputs, pos), **tol)
    outs = {}
    for dev, model in (("cpu", cpu), ("cuda", card)):
        x, p = inputs.to(dev), pos.to(dev)
        logits, cache = ts.prefill(model, x[:, :s - 3], p[:, :s - 3], s + 4)
        steps = [logits.cpu()]
        for t in range(s - 3, s):
            logits, cache = ts.decode_step(model, cache, x[:, t:t + 1], t)
            steps.append(logits.cpu())
        outs[dev] = (steps, [{k: v.cpu() for k, v in c.items()}
                             for c in cache])
    for got, want in zip(outs["cuda"][0], outs["cpu"][0]):
        torch.testing.assert_close(got, want, **tol)
    for got, want in zip(outs["cuda"][1], outs["cpu"][1]):
        for k in want:
            torch.testing.assert_close(got[k], want[k], **tol)


@needs_cuda
def test_placed_search_on_a_four_entry_card_mesh():
    """``place_sharded`` on a 4-entry mesh of the card: each shard block is
    searched where it lives and summed; every field equals the unplaced
    search on the card and the same index on the CPU."""
    from repro_torch.core import index as hix
    from repro_torch.launch.mesh import make_mesh_compat, make_shard_mesh
    from repro_torch.launch.shardings import PlacedTensor, place_sharded
    values = np.random.default_rng(41).integers(0, 2555, 20000).astype(
        np.float32)
    preds = [Predicate.between(float(lo), float(lo + w)) for lo, w in
             zip(np.random.default_rng(42).integers(0, 2500, 24),
                 [0, 9, 99] * 8)]
    res = {}
    for dev in ("cpu", "cuda"):
        idx = ShardedHippoIndex.create(PagedTable.from_values(values, 50),
                                       num_shards=4, device=dev)
        keys, valid = idx._slabs()
        qbms, los, his = idx._query_bitmaps(preds)
        meshes = [None, make_mesh_compat((4,), ("data",), [idx.device] * 4)]
        if dev == "cuda":
            meshes.append(make_shard_mesh(4))
        for mesh in meshes:
            if mesh is None:
                st, k, v = idx.state, keys, valid
            else:
                st, k, v = place_sharded(mesh, idx.state, keys, valid)
                assert isinstance(k, PlacedTensor) == (mesh.size > 1)
            dense = hix.search_many_sharded(st.shards, qbms, k, v, los, his)
            compact = hix.search_compact_many_sharded(
                st.shards, qbms, k, v, los, his,
                max_selected=idx.spec.pages_per_shard, top_k=8)
            res[(dev, None if mesh is None else mesh.size)] = [
                t.cpu() for t in (*dense, *compact)]
    want = res[("cpu", None)]
    for key, got in res.items():
        for g, w in zip(got, want):
            assert torch.equal(g, w), key


@needs_cuda
def test_cuda_tensor_raises_when_the_library_fails(monkeypatch):
    def broken():
        raise RuntimeError("nvcc failed")
    monkeypatch.setattr(_build, "library", broken)
    v = torch.zeros(8, device="cuda")
    b = torch.arange(5, dtype=torch.float32, device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bk_ops.bucketize_values(v, b, 4)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_sources_hash_changes_with_flags(monkeypatch):
    before = _build.source_hash()
    monkeypatch.setattr(_build, "COMPILE_FLAGS", [*_build.COMPILE_FLAGS, "-g"])
    assert _build.source_hash() != before
    assert [p.name for p in _build.sources()] == [
        "batch_filter.cu", "bitmap_and.cu", "bucketize.cu",
        "compact_inspect.cu", "page_inspect.cu"]


def test_sources_and_hash_of_another_directory(tmp_path):
    (tmp_path / "a.cu").write_text("// a\n")
    (tmp_path / "shared.cuh").write_text("// one\n")
    assert [p.name for p in _build.sources(tmp_path)] == ["a.cu"]
    before = _build.source_hash(tmp_path)
    assert before != _build.source_hash()
    (tmp_path / "shared.cuh").write_text("// two\n")   # headers are hashed
    assert _build.source_hash(tmp_path) != before


TRAIN_ARCHS = ["smollm-360m", "qwen2-moe-a2.7b", "recurrentgemma-9b",
               "rwkv6-3b"]


@needs_cuda
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_steps_on_card_equal_cpu(arch):
    """Two train steps of the reduced config (float32, TF32 off; MoE with
    no capacity drops) on the same batch, on the card and on the CPU from
    the same weights: loss and grad norm per step within 1e-4 relative;
    the parameters after them within 1e-4 on at least 99.9% of entries and
    none off by more than 2 * lr a step (Adam's first steps move an entry
    by about lr * sign(g), so a gradient near zero may flip its sign)."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as tsteps
    from repro_torch.models import transformer as tt
    from repro_torch.optim import adamw_init
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get_config(arch).reduced()
    if cfg.num_experts:
        cfg = replace(cfg, capacity_factor=8.0)
    rng = np.random.default_rng(2)
    b, s = 4, 16
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (b, s)),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)),
             "positions": np.broadcast_to(np.arange(s)[None], (b, s)).copy()}
    out = {}
    for dev in ("cpu", "cuda"):
        model = tt.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu").to(dev)
        opt = adamw_init(model)
        step = tsteps.make_train_step(cfg, peak_lr=1e-3, warmup=0, total=10)
        metrics = []
        for _ in range(2):
            model, opt, m = step(model, opt, {k: torch.from_numpy(v).to(dev)
                                              for k, v in batch.items()})
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        out[dev] = (metrics, {n: p.detach().cpu()
                              for n, p in model.named_parameters()})
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    off = total = 0
    for n, p in out["cpu"][1].items():
        diff = (out["cuda"][1][n] - p).abs()
        off += int((diff > 1e-4 + 1e-4 * p.abs()).sum())
        total += p.numel()
        assert float(diff.max()) <= 2 * 2 * 1e-3, n
    assert off <= 1e-3 * total


@needs_cuda
def test_pipeline_selection_on_card_equals_brute_force():
    """The Hippo-indexed corpus on the card: the build runs the bucket
    probe, the selection the single-query filter and inspection; the
    selected sequences and pages inspected equal the CPU's and brute
    force."""
    from repro_torch import kernels as K
    from repro_torch.data import HippoDataPipeline, synthesize_corpus
    corpus = synthesize_corpus(num_seqs=8192, seq_len=9, vocab_size=1000,
                               seed=4)
    for lo, hi in ((0.5, 1.0), (0.8, 0.9), (0.0, 1.0)):
        K.reset_launch_counts()
        card = HippoDataPipeline.create(corpus, Predicate.between(lo, hi),
                                        device="cuda")
        launches = K.launch_counts()
        assert all(launches[k] > 0 for k in ("bucketize", "bitmap_and",
                                             "page_inspect"))
        cpu = HippoDataPipeline.create(corpus, Predicate.between(lo, hi),
                                       device="cpu")
        brute = np.flatnonzero((corpus.quality >= lo) & (corpus.quality <= hi))
        np.testing.assert_array_equal(card.selected_ids, brute)
        np.testing.assert_array_equal(cpu.selected_ids, brute)
        assert card.pages_inspected == cpu.pages_inspected
        np.testing.assert_array_equal(card.get_batch(3, 5)["inputs"],
                                      cpu.get_batch(3, 5)["inputs"])


@needs_cuda
def test_bfloat16_logits_and_loss_on_card_equal_cpu():
    """Reduced smollm in bfloat16 from the same weights: the serving
    forward's logits on the card against the CPU within the CPU parity
    test's bounds (max 0.05, mean 0.01: about one bfloat16 ulp at 4), and
    the training loss within 1e-2 relative."""
    from dataclasses import replace
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tt
    cfg = replace(get_config("smollm-360m").reduced(), dtype="bfloat16")
    rng = np.random.default_rng(1)
    b, s = 2, 32
    batch = {"inputs": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s))),
             "labels": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (b, s))),
             "positions": torch.arange(s)[None].expand(b, s)}
    out = {}
    for dev in ("cpu", "cuda"):
        model = tt.init_params(cfg, torch.Generator().manual_seed(0),
                               "cpu").to(dev)
        bt = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad():
            logits = tt.forward(model, bt["inputs"], bt["positions"])
            loss = tt.loss_fn(model, bt)
        assert logits.dtype == torch.bfloat16
        out[dev] = (logits.float().cpu().numpy(), float(loss))
    diff = np.abs(out["cuda"][0] - out["cpu"][0])
    assert diff.max() <= 0.05 and diff.mean() <= 0.01
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-2)


@needs_cuda
def test_measure_cuda_stream_is_finite_and_cached():
    from repro_torch import roofline
    a = roofline.measure_cuda_stream(mbytes=64, reps=3)
    assert math.isfinite(a) and a > 0
    assert roofline.measure_cuda_stream(mbytes=64, reps=3) == a
    hw = roofline.hardware()
    assert hw.name == "cuda_stream" and hw is roofline.hardware("cuda_stream")
    assert torch.cuda.get_device_name(0) in hw.note


@needs_cuda
def test_dry_run_blocks_on_the_card_take_the_records_bytes():
    """The blocks that mesh position 0 holds of a small cell's arguments,
    allocated on the card: the caching allocator is asked for the record's
    bytes exactly, and counts at most its rounding more (512 B a block, up
    to 1 MiB of a large block that it does not split)."""
    from repro_torch.configs import get_config, shape_cells
    from repro_torch.launch import dryrun
    cfg = get_config("smollm-360m")
    shape = next(s for s in shape_cells(cfg) if s.name == "prefill_32k")
    rec = dryrun.lower_cell(cfg.name, shape.name, False)
    assert rec["hbm_bytes"] == torch.cuda.get_device_properties(
        0).total_memory and rec["arguments_fit_hbm"]
    _, blocks, _ = dryrun.cell_blocks(cfg, shape, False)
    torch.cuda.synchronize()
    stat = "requested_bytes.all.current"
    base = torch.cuda.memory_stats()[stat], torch.cuda.memory_allocated()
    held = [torch.empty(s, dtype=d, device="cuda") for s, d in blocks]
    requested = torch.cuda.memory_stats()[stat] - base[0]
    rise = torch.cuda.memory_allocated() - base[1]
    del held
    want = rec["memory"]["argument_bytes_per_device"]
    assert requested == want
    assert 0 <= rise - want <= (2**20 + 512) * len(blocks)


# the examples' timing fields: "19.0 ms", "(10499 q/s)", "speedup 14.1x"
EXAMPLE_TIMING = r"\d+(?:\.\d+)?(?= ms\b| q/s\b|x$)"


@needs_cuda
@pytest.mark.parametrize("name", ["quickstart", "engine_serving"])
def test_example_on_the_card_prints_the_cpu_lines(name, capsys):
    """``python -m repro_torch.examples.<name>`` on the card (its default
    device) prints the ``--device cpu`` run's lines, timings masked."""
    import importlib
    import re
    example = importlib.import_module(f"repro_torch.examples.{name}")
    example.main(["--device", "cpu"])
    want = capsys.readouterr().out
    example.main([])
    got = capsys.readouterr().out

    def masked(text):
        return [re.sub(EXAMPLE_TIMING, "#", ln) for ln in text.splitlines()]

    assert masked(got) == masked(want)
