"""Port parity: ``repro_torch.core.histogram`` against ``repro.core.histogram``.

Bounds must be bit-equal: the port reproduces ``jnp.quantile``'s float32
interpolation (with its fused multiply-add) on the host. Bucket ids must
equal the reference's searchsorted path and its Pallas kernel (interpret
mode).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import histogram as jhg
from repro.kernels.bucketize.ops import bucketize_values as pallas_bucketize
from repro_torch.core import histogram as thg


def _sample(kind: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.uniform(0.0, 1e6, n).astype(np.float32)
    if kind == "shipdate":
        return rng.integers(0, 2555, n).astype(np.float32)
    if kind == "zipf":
        return np.minimum(rng.zipf(1.3, n), 1e7).astype(np.float32)
    if kind == "large":
        return (1e8 + rng.uniform(0.0, 5000.0, n)).astype(np.float32)
    if kind == "normal":
        return rng.normal(0.0, 1.0, n).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["uniform", "shipdate", "zipf", "large",
                                  "normal"])
@pytest.mark.parametrize("h,n", [(400, 65536), (64, 3001)])
def test_build_bounds_bit_equal_to_reference(kind, h, n):
    sample = _sample(kind, n, seed=h + n)
    ref = np.asarray(jhg.build(jnp.asarray(sample), h).bounds)
    got = thg.build(sample, h, device="cpu").bounds
    assert got.dtype == torch.float32 and got.shape == (h + 1,)
    assert np.array_equal(got.numpy().view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("kind", ["uniform", "shipdate", "large"])
def test_bucketize_equals_reference_and_pallas_kernel(kind):
    sample = _sample(kind, 20000, seed=7)
    hist_j = jhg.build(jnp.asarray(sample), 400)
    hist_t = thg.build(sample, 400, device="cpu")
    b = np.asarray(hist_j.bounds)
    probe = np.concatenate([sample[:1500], b, np.nextafter(b, np.inf),
                            np.nextafter(b, -np.inf),
                            [3.4e38, -3.4e38, b[0] - 1, b[-1] + 1]]
                           ).astype(np.float32)
    ref = np.asarray(jhg.bucketize(hist_j, jnp.asarray(probe)))
    got = thg.bucketize(hist_t, torch.from_numpy(probe))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    pallas = np.asarray(pallas_bucketize(jnp.asarray(probe), hist_j.bounds,
                                         400, interpret=True))
    assert np.array_equal(got.numpy(), pallas)


def test_hit_bucket_range_matches_reference():
    sample = _sample("shipdate", 10000, seed=3)
    hist_j = jhg.build(jnp.asarray(sample), 64)
    hist_t = thg.build(sample, 64, device="cpu")
    for lo, hi in [(10.0, 20.0), (0.0, 0.0), (-50.0, -1.0), (3000.0, 4000.0),
                   (20.0, 10.0), (-1e30, 1e30), (2554.0, 9999.0)]:
        ref = tuple(int(x) for x in jhg.hit_bucket_range(hist_j, lo, hi))
        assert thg.hit_bucket_range(hist_t, lo, hi) == ref, (lo, hi)


@pytest.mark.parametrize("hi,h", [(1.0, 400), (1.0, 64), (1024.0, 400)]
                         + [(hi, h) for hi in (100.0, 300.0, 2555.0, 200000.0,
                                               7.0, 9999.0, 123456.7)
                            for h in (1, 3, 7, 64, 100, 255, 400, 1000)])
def test_build_uniform_unit_steps_bit_equal(hi, h):
    # lo = 0, as every caller passes it: the port replays XLA's linspace
    # steps, f32(i * f32(f32(hi) * f32(1/H))), and ends exactly at hi
    # (lo != 0 may differ in the last bit: ROADMAP.md, Faults)
    ref = np.asarray(jhg.build_uniform(0.0, hi, h).bounds)
    got = thg.build_uniform(0.0, hi, h, device="cpu").bounds.numpy()
    assert np.array_equal(got.view(np.int32), ref.view(np.int32))


def test_strict_float32_bounds_is_the_reference_finalizer():
    rng = np.random.default_rng(5)
    raw = np.sort(np.concatenate([np.full(50, 1e8), rng.uniform(0, 3, 30),
                                  np.zeros(20)]))
    assert np.array_equal(thg.strict_float32_bounds(raw),
                          jhg.strict_float32_bounds(raw))


def test_to_bucket_bitmaps_equal_reference():
    from repro.core.predicate import Predicate as JPred
    from repro.core.predicate import to_bucket_bitmaps as j_convert
    from repro_torch.core.predicate import Predicate as TPred
    from repro_torch.core.predicate import to_bucket_bitmaps as t_convert
    sample = _sample("shipdate", 8000, seed=4)
    hist_j = jhg.build(jnp.asarray(sample), 400)
    hist_t = thg.build(sample, 400, device="cpu")
    spans = [(10.0, 20.0), (0.0, 0.0), (7.0, 2.0), (-np.inf, np.inf),
             (2554.0, 1e9), (-5.0, -1.0), (1000.0, 1099.0)]
    ref = np.asarray(j_convert([JPred.between(*s) for s in spans], hist_j))
    got = t_convert([TPred.between(*s) for s in spans], hist_t)
    assert np.array_equal(got.numpy().view(np.uint32), ref)
    assert t_convert([], hist_t).shape == (0, 13)
