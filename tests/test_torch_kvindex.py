"""HippoKV in the port against the reference, on the CPU.

The same seeded numpy key cache (clustered by page, as
``tests/test_kvindex.py`` builds it) goes through ``repro.core.kvindex`` and
``repro_torch.core.kvindex``. Channels, bounds, bitmaps and page masks must
be equal; attention output and kept mass agree within rtol 1e-5, atol 1e-6
(float32 products summed in another order). Run:

    JAX_PLATFORMS=cpu PYTHONPATH=src python -m pytest -q tests/test_torch_kvindex.py
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import kvindex as ref
from repro_torch import convert
from repro_torch.core import kvindex as port
from repro_torch.kernels import _build

CONFIGS = [dict(), dict(page_size=32, num_channels=12, resolution=40,
                        keep_buckets=6),
           dict(page_size=16, num_channels=4, resolution=33, keep_buckets=1),
           dict(page_size=64, num_channels=8, resolution=16, keep_buckets=12)]


def cache(seed: int, b=2, s=512, h=4, hd=32, ps=64):
    """Keys clustered by page (a center per page and head, plus noise),
    values and one decode query, float32."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((s // ps, 1, h, hd)).astype(np.float32)
    keys = np.repeat(centers, ps, axis=0).reshape(s, 1, h, hd)
    keys = (keys.transpose(1, 0, 2, 3)
            + 0.3 * rng.standard_normal((b, s, h, hd))).astype(np.float32)
    values = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    return keys, values, q


def _both(cfg_kw, keys):
    r = ref.build_kv_index(ref.KVIndexConfig(**cfg_kw), jnp.asarray(keys))
    p = port.build_kv_index(port.KVIndexConfig(**cfg_kw),
                            torch.from_numpy(keys))
    return r, p


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg_kw", CONFIGS)
def test_channels_bounds_bitmaps_equal_reference(cfg_kw, seed):
    keys, _, _ = cache(seed)
    r, p = _both(cfg_kw, keys)
    assert np.array_equal(np.asarray(r.channels), p.channels.numpy())
    assert p.channels.dtype == torch.int32
    # bit equality of every bound
    assert np.array_equal(np.asarray(r.bounds).view(np.int32),
                          p.bounds.numpy().view(np.int32))
    assert np.array_equal(np.asarray(r.bitmaps),
                          p.bitmaps.numpy().view(np.uint32))
    assert p.num_pages == r.num_pages and p.nbytes() == r.nbytes()


@pytest.mark.parametrize("min_channels", [1, 2, 4])
@pytest.mark.parametrize("cfg_kw", CONFIGS[:2])
def test_page_masks_equal_reference(cfg_kw, min_channels):
    keys, _, q = cache(7)
    r, p = _both(cfg_kw, keys)
    q[0, 0, :4] = [0.0, -0.0, 1e-30, -1e-30]       # signs at zero
    want = np.asarray(ref.query_page_mask(r, jnp.asarray(q), min_channels))
    got = port.query_page_mask(p, torch.from_numpy(q), min_channels)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("min_channels", [1, 3])
def test_attention_and_kept_mass_match_reference(min_channels):
    keys, values, q = cache(3)
    r, p = _both({}, keys)
    mask = port.query_page_mask(p, torch.from_numpy(q), min_channels)
    out, mass = port.hippo_kv_attention(torch.from_numpy(q),
                                        torch.from_numpy(keys),
                                        torch.from_numpy(values), mask, 64)
    want_out, want_mass = ref.hippo_kv_attention(
        jnp.asarray(q), jnp.asarray(keys), jnp.asarray(values),
        jnp.asarray(mask.numpy()), 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mass.numpy(), np.asarray(want_mass),
                               rtol=1e-5, atol=1e-6)
    assert out.dtype == torch.float32 and mass.shape == (2, 4)


def test_full_keep_equals_exact_attention():
    keys, values, q = cache(4)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, keys, values))
    out, mass = port.hippo_kv_attention(tq, tk, tv,
                                        torch.ones((2, 4, 8), dtype=bool), 64)
    scores = torch.einsum("bhd,bshd->bhs", tq, tk) / np.sqrt(32)
    exact = torch.einsum("bhs,bshd->bhd", torch.softmax(scores, -1), tv)
    np.testing.assert_allclose(out.numpy(), exact.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mass.numpy(), 1.0, rtol=1e-5)


def test_bucket_ids_take_the_plain_probe_on_the_cpu(monkeypatch):
    """The CPU build never touches the kernel library."""
    def no_library():
        raise AssertionError("the CPU path must not touch the kernel library")
    monkeypatch.setattr(_build, "library", no_library)
    keys, _, _ = cache(5)
    r, p = _both({}, keys)
    assert np.array_equal(np.asarray(r.bitmaps),
                          p.bitmaps.numpy().view(np.uint32))


def test_build_from_an_array_needs_the_card_unless_told():
    keys, _, _ = cache(6)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port.build_kv_index(port.KVIndexConfig(), keys)
    r, _ = _both({}, keys)
    p = port.build_kv_index(port.KVIndexConfig(), keys, device="cpu")
    assert np.array_equal(np.asarray(r.bitmaps),
                          p.bitmaps.numpy().view(np.uint32))


def test_kvindex_from_arrays_gives_the_same_masks():
    keys, _, q = cache(8)
    cfg = ref.KVIndexConfig(num_channels=6, resolution=24, keep_buckets=3)
    r = ref.build_kv_index(cfg, jnp.asarray(keys))
    p = convert.kvindex_from_arrays(cfg, np.asarray(r.channels),
                                    np.asarray(r.bounds),
                                    np.asarray(r.bitmaps), device="cpu")
    assert p.cfg == port.KVIndexConfig(num_channels=6, resolution=24,
                                       keep_buckets=3)
    for mc in (1, 2, 4):
        assert np.array_equal(
            port.query_page_mask(p, torch.from_numpy(q), mc).numpy(),
            np.asarray(ref.query_page_mask(r, jnp.asarray(q), mc)))
