"""Port parity: ``repro_torch.core.bitmap`` against ``repro.core.bitmap``.

The port carries packed words as int32 holding the reference's uint32 bits;
every comparison views them back as uint32 and asserts exact equality,
including words with bit 31 set.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bitmap as jbm
from repro_torch.core import bitmap as tbm


def _u32(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


def _random_words(rng, shape) -> np.ndarray:
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[::3] |= np.uint32(1 << 31)
    w.reshape(-1)[1::7] = np.uint32(0xFFFFFFFF)
    w.reshape(-1)[2::11] = 0
    return w


@pytest.mark.parametrize("h", [1, 31, 32, 33, 64, 400])
def test_from_bool_and_to_bool_match_reference(h):
    rng = np.random.default_rng(h)
    bits = rng.random((4, 3, h)) < 0.5
    bits[0, 0] = True                  # every bit, so bit 31 of each word
    ref = np.asarray(jbm.from_bool(jnp.asarray(bits)))
    got = tbm.from_bool(torch.from_numpy(bits))
    assert got.shape == ref.shape
    assert np.array_equal(_u32(got), ref)
    back = tbm.to_bool(got, h)
    assert np.array_equal(back.numpy(), bits)
    assert np.array_equal(back.numpy(),
                          np.asarray(jbm.to_bool(jnp.asarray(ref), h)))


def test_popcount_matches_reference_with_bit31_words():
    rng = np.random.default_rng(0)
    words = _random_words(rng, (50, 13))
    ref = np.asarray(jbm.popcount(jnp.asarray(words)))
    got = tbm.popcount(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)


def test_any_joint_matches_reference_broadcast():
    rng = np.random.default_rng(1)
    q = _random_words(rng, (6, 13)) & _random_words(rng, (6, 13)) \
        & _random_words(rng, (6, 13))
    e = _random_words(rng, (40, 13)) & _random_words(rng, (40, 13)) \
        & _random_words(rng, (40, 13))
    q[0] = 0
    q[1] = 0
    q[1, -1] = np.uint32(1 << 31)      # only bit 31
    ref = np.asarray(jbm.any_joint(jnp.asarray(q)[:, None, :],
                                   jnp.asarray(e)[None, :, :]))
    tq = torch.from_numpy(q.view(np.int32))
    te = torch.from_numpy(e.view(np.int32))
    got = tbm.any_joint(tq[:, None, :], te[None, :, :])
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("h", [64, 400])
def test_range_mask_matches_reference(h):
    pairs = [(0, 0), (0, h - 1), (31, 32), (5, 4), (h - 1, h + 40), (30, 95),
             (-3, 2)]
    ref = np.stack([np.asarray(jbm.range_mask(h, lo, hi)) for lo, hi in pairs])
    lo = torch.tensor([p[0] for p in pairs])
    hi = torch.tensor([p[1] for p in pairs])
    assert np.array_equal(_u32(tbm.range_mask(h, lo, hi)), ref)


def test_num_words_and_zeros():
    for h in (1, 32, 33, 400, 1024):
        assert tbm.num_words(h) == jbm.num_words(h)
    z = tbm.zeros(400, 3, 2, device="cpu")
    assert z.shape == (3, 2, 13) and z.dtype == torch.int32
    assert not z.any()
