"""Port parity: NaN keys and NaN predicate endpoints.

The reference's core buckets with ``jnp.searchsorted(side="right") - 1``,
which sorts NaN after every bound: a NaN value lands in bucket H-1. The
port's core does the same through the bucket probe's ``nan_last`` flag, on
the CPU here (the plain version) and on the card (the kernel; held in
``tests/test_torch_cuda.py``). With the flag clear the probe keeps the TPU
kernel's formula, which gives NaN bucket 0
(``tests/test_torch_kernels.py``).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import histogram as jhg
from repro.core import index as jix
from repro.core.hippo import HippoIndex as JHippo
from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.core.predicate import to_bucket_bitmaps as j_convert
from repro.storage.table import PagedTable as JTable
from repro_torch.core import histogram as thg
from repro_torch.core.hippo import HippoIndex as THippo
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.core.predicate import to_bucket_bitmaps as t_convert
from repro_torch.kernels.bucketize.ops import (bucketize_ref,
                                                bucketize_values)
from repro_torch.storage.table import PagedTable as TTable

NAN = float("nan")
# NaN with the sign bit set and NaNs with other payloads, beside +-0, +-inf
NANS = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFFFFFFFF],
                np.uint32).view(np.float32)
PROBE = np.concatenate([NANS, np.array([-0.0, 0.0, np.inf, -np.inf, 3.4e38,
                                        -3.4e38, 5.0, 99.0], np.float32)])


def _hists(h):
    return (jhg.build_uniform(0.0, 100.0, h),
            thg.build_uniform(0.0, 100.0, h, device="cpu"))


@pytest.mark.parametrize("h", [1, 16, 400])
def test_bucketize_nan_lands_where_the_reference_puts_it(h):
    hj, ht = _hists(h)
    ref = np.asarray(jhg.bucketize(hj, jnp.asarray(PROBE)))
    got = thg.bucketize(ht, torch.from_numpy(PROBE))
    assert np.array_equal(got.numpy(), ref)
    assert (got.numpy()[: NANS.size] == h - 1).all()
    # the flag changes NaN values only; clear, NaN gets the formula's 0
    plain = bucketize_values(torch.from_numpy(PROBE), ht.bounds, h,
                             nan_last=False)
    assert (plain.numpy()[: NANS.size] == 0).all()
    assert np.array_equal(plain.numpy()[NANS.size:], ref[NANS.size:])
    assert torch.equal(bucketize_ref(torch.from_numpy(PROBE), ht.bounds, h,
                                     nan_last=True), got)


@pytest.mark.parametrize("h", [16, 400])
def test_nan_endpoints_convert_and_hit_like_the_reference(h):
    hj, ht = _hists(h)
    spans = [(NAN, 5.0), (3.0, NAN), (NAN, NAN), (-np.inf, NAN), (2.0, 7.0)]
    ref = np.asarray(j_convert([JPred.between(*s) for s in spans], hj))
    got = t_convert([TPred.between(*s) for s in spans], ht)
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    for lo, hi in spans:
        want = tuple(int(x) for x in jhg.hit_bucket_range(hj, lo, hi))
        assert thg.hit_bucket_range(ht, lo, hi) == want, (lo, hi)


def _nan_keys(n, seed):
    vals = np.random.default_rng(seed).integers(0, 2555, n).astype(np.float32)
    vals[[7, 1234, n - 3]] = NAN
    return vals


def _assert_state_equal(js, ts):
    for f in jix.HippoState._fields:
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        if a.dtype == np.uint32:
            b = b.view(np.uint32)
        assert np.array_equal(a, b), f


def _assert_results_equal(jres, tres):
    for f in jres._fields:
        a, b = np.asarray(getattr(jres, f)), getattr(tres, f).numpy()
        assert np.array_equal(a, b), f


SPANS = [(NAN, 50.0), (2000.0, NAN), (10.0, 60.0), (NAN, NAN)]


def test_sharded_state_and_compact_results_with_nans_equal_reference():
    # NaN keys under an explicit histogram (a sampled one turns every bound
    # NaN in both packages), then NaN endpoints: the bitmaps hold bucket
    # H-1 for the NaN keys, and pages_inspected/entries_matched agree
    vals = _nan_keys(5000, 1)
    hj = jhg.build_uniform(0.0, 2555.0, 64)
    ht = thg.build_uniform(0.0, 2555.0, 64, device="cpu")
    j = JSharded.create(JTable.from_values(vals, 50), num_shards=2,
                        resolution=64, hist=hj)
    t = TSharded.create(TTable.from_values(vals, 50), num_shards=2,
                        resolution=64, hist=ht, device="cpu")
    _assert_state_equal(j.state.shards, t.state.shards)
    assert np.array_equal(np.asarray(j.state.summaries),
                          t.state.summaries.numpy().view(np.uint32))
    jp = [JPred.between(*s) for s in SPANS]
    tp = [TPred.between(*s) for s in SPANS]
    for m, k in ((j.gather_cap, 4), (3, 0)):
        _assert_results_equal(j.search_compact_batch(jp, max_selected=m,
                                                     top_k=k),
                              t.search_compact_batch(tp, max_selected=m,
                                                     top_k=k))
    # NaN inserts set bucket H-1 too, eagerly and in a batch
    for idx in (j, t):
        idx.insert(NAN)
        idx.insert_batch(np.array([NAN, 3.0] * 40, np.float32))
    _assert_state_equal(j.state.shards, t.state.shards)


def test_unsharded_search_with_nans_equals_reference():
    vals = _nan_keys(3000, 2)
    hj = jhg.build_uniform(0.0, 2555.0, 16)
    ht = thg.build_uniform(0.0, 2555.0, 16, device="cpu")
    j = JHippo.create(JTable.from_values(vals, 50), resolution=16, hist=hj)
    t = THippo.create(TTable.from_values(vals, 50), resolution=16,
                      device="cpu", hist=ht)
    _assert_state_equal(j.state, t.state)
    for s in SPANS:
        _assert_results_equal(j.search(JPred.between(*s)),
                              t.search(TPred.between(*s)))
