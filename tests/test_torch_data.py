"""The port's training data plane (``repro_torch.data``) against the JAX
package's, on the CPU: the synthetic corpus, the Hippo selection and the
batches are equal exactly."""
import gc
import threading

import jax
import numpy as np
import pytest
import torch

from repro.core.predicate import Predicate as JPred
from repro.data import HippoDataPipeline as JPipe
from repro.data import synthesize_corpus as jsynth
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.data import HippoDataPipeline as TPipe
from repro_torch.data import synthesize_corpus as tsynth


@pytest.fixture(autouse=True, scope="module")
def _light_worker():
    """One torch intra-op thread for these tiny shapes; JAX's compile caches
    dropped at the end."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()
    gc.collect()


@pytest.mark.parametrize("kw", [
    dict(num_seqs=4096, seq_len=33, vocab_size=256),
    dict(num_seqs=1000, seq_len=9, vocab_size=50_000, page_card=16, seed=3,
         shard_run=100)])
def test_synthesize_corpus_equals_reference(kw):
    j, t = jsynth(**kw), tsynth(**kw)
    for name in ("tokens", "quality", "domain"):
        a, b = getattr(t, name), getattr(j, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, name)
    assert t.page_card == j.page_card and t.num_seqs == j.num_seqs
    for name in ("keys", "valid", "num_pages", "fill", "capacity_pages"):
        np.testing.assert_array_equal(getattr(t.table, name),
                                      getattr(j.table, name), name)
    pages = np.array([0, 3, t.table.num_pages - 1])
    np.testing.assert_array_equal(t.seq_ids_for_pages(pages),
                                  j.seq_ids_for_pages(pages))


@pytest.fixture(scope="module")
def corpora():
    kw = dict(num_seqs=6000, seq_len=17, vocab_size=512, seed=7)
    return jsynth(**kw), tsynth(**kw)


@pytest.mark.parametrize("lo,hi", [(0.5, 1.0), (0.8, 1.0), (0.0, 1.0),
                                   (0.3, 0.31), (0.74, 0.76)])
def test_selection_and_batches_equal_reference(corpora, lo, hi):
    """``HippoDataPipeline.create`` selects the reference's sequences with
    the same pages inspected (the index prunes: domains arrive in runs), and
    every batch equals the reference's."""
    jc, tc = corpora
    jp = JPipe.create(jc, JPred.between(lo, hi), seed=5)
    tp = TPipe.create(tc, TPred.between(lo, hi), seed=5, device="cpu")
    assert tp.index.device.type == "cpu"
    np.testing.assert_array_equal(tp.selected_ids, jp.selected_ids)
    assert tp.pages_inspected == jp.pages_inspected
    brute = np.flatnonzero((tc.quality >= lo) & (tc.quality <= hi))
    np.testing.assert_array_equal(tp.selected_ids, brute)
    if hi - lo < 1.0:
        assert tp.pages_inspected < tc.table.num_pages
    for step in (0, 1, 17):
        for b in (4, 9):
            np.testing.assert_array_equal(tp.batch_ids(step, b),
                                          jp.batch_ids(step, b))
            got, want = tp.get_batch(step, b), jp.get_batch(step, b)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k], k)


def test_small_selection_samples_with_replacement(corpora):
    jc, tc = corpora
    q = np.sort(tc.quality)
    lo, hi = float(q[100]), float(q[104])               # five sequences
    brute = np.flatnonzero((tc.quality >= lo) & (tc.quality <= hi))
    assert 0 < brute.size < 8
    jp = JPipe.create(jc, JPred.between(lo, hi))
    tp = TPipe.create(tc, TPred.between(lo, hi), device="cpu")
    np.testing.assert_array_equal(tp.batch_ids(3, 8), jp.batch_ids(3, 8))
    with pytest.raises(ValueError, match="selects no sequences"):
        JPipe.create(jc, JPred.between(5.0, 6.0))
    with pytest.raises(ValueError, match="selects no sequences"):
        TPipe.create(tc, TPred.between(5.0, 6.0), device="cpu")


def test_iter_batches_prefetches_the_batches_and_ends_its_thread(corpora):
    _, tc = corpora
    tp = TPipe.create(tc, TPred.between(0.5, 1.0), seed=1, device="cpu")
    before = threading.active_count()
    got = list(tp.iter_batches(4, 5, 3, prefetch=2))
    assert [s for s, _ in got] == [4, 5, 6, 7, 8]
    for s, batch in got:
        want = tp.get_batch(s, 3)
        for k in want:
            np.testing.assert_array_equal(batch[k], want[k])
    # dropped after one batch: the producer sees it and ends
    it = tp.iter_batches(0, 100, 3, prefetch=1)
    next(it)
    it.close()
    assert threading.active_count() == before


def test_refresh_swaps_the_selection(corpora):
    _, tc = corpora
    tp = TPipe.create(tc, TPred.between(0.0, 1.0), device="cpu")
    assert tp.selected_ids.size == tc.num_seqs
    tp.predicate = TPred.between(0.75, 1.0)
    tp.refresh_selection()
    np.testing.assert_array_equal(
        tp.selected_ids, np.flatnonzero(tc.quality >= 0.75))


def test_device_none_means_the_card(corpora):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TPipe.create(corpora[1], TPred.between(0.5, 1.0))
