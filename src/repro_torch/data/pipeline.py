"""Hippo-indexed data pipeline: predicate-filtered, deterministic, prefetched
(port of ``repro.data.pipeline``).

Selection runs Algorithm 1 over the corpus metadata table on the device
(``HippoIndex.search``: the joint-bucket filter and the page inspection, the
kernels ``bitmap_and`` and ``page_inspect`` on the card): the quality-range
predicate is AND-filtered against the page summaries, only possibly
qualified pages are inspected, and the exact qualifying sequence set comes
back to the host in one copy of the tuple mask. The pipeline then samples
batches from that set with a *stateless* step->batch mapping (a
counter-based RNG keyed on (seed, step)), so restarts reproduce the exact
same batch for any step — the checkpoint only needs to store the step
number (see ``runtime/fault.py``).

``iter_batches`` prefetches on a producer thread, which reads the selection
while the caller may refresh it; the selection is swapped under a lock.
"""
from __future__ import annotations

import itertools
import queue
import threading

import numpy as np

from repro_torch.core.hippo import HippoIndex
from repro_torch.core.predicate import Predicate
from repro_torch.data.corpus import PagedCorpus

_PUT_WAIT_S = 0.1      # the producer's wait between checks that the
                       # consumer is still there


class HippoDataPipeline:
    """Batches of the corpus sequences that ``predicate`` selects."""

    def __init__(self, corpus: PagedCorpus, index: HippoIndex,
                 predicate: Predicate, seed: int = 0):
        self.corpus = corpus
        self.index = index
        self.predicate = predicate
        self.seed = seed
        self.pages_inspected = 0
        self._lock = threading.Lock()
        self._selected = np.zeros(0, np.int64)      # guarded-by: _lock

    @staticmethod
    def create(corpus: PagedCorpus, predicate: Predicate, *,
               resolution: int = 128, density: float = 0.15, seed: int = 0,
               device=None) -> "HippoDataPipeline":
        """Index the corpus's quality column on ``device`` (None: the card)
        and select the predicate's sequences."""
        index = HippoIndex.create(corpus.table, resolution=resolution,
                                  density=density, device=device)
        pipe = HippoDataPipeline(corpus=corpus, index=index,
                                 predicate=predicate, seed=seed)
        pipe.refresh_selection()
        return pipe

    # -- selection (the paper's access path) ---------------------------------

    @property
    def selected_ids(self) -> np.ndarray:
        with self._lock:
            return self._selected

    def refresh_selection(self) -> None:
        res = self.index.search(self.predicate)
        qual = res.qualified.cpu().numpy()            # (pages, page_card) bool
        flat = qual.ravel()[: self.corpus.num_seqs]
        ids = np.flatnonzero(flat)
        self.pages_inspected = int(res.pages_inspected)
        if ids.size == 0:
            raise ValueError("predicate selects no sequences")
        with self._lock:
            self._selected = ids

    # -- deterministic batching ------------------------------------------------

    def batch_ids(self, step: int, batch_size: int) -> np.ndarray:
        with self._lock:
            selected = self._selected
        rng = np.random.default_rng((self.seed, step))
        return rng.choice(selected, size=batch_size,
                          replace=selected.size < batch_size)

    def get_batch(self, step: int, batch_size: int) -> dict:
        ids = self.batch_ids(step, batch_size)
        toks = self.corpus.tokens[ids]
        b, s = toks.shape
        return {
            "inputs": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
            "positions": np.broadcast_to(np.arange(s - 1, dtype=np.int32)[None],
                                         (b, s - 1)).copy(),
        }

    # -- prefetch -----------------------------------------------------------------

    def _produce(self, q: queue.Queue, done: threading.Event, stop,
                 start_step: int, num_steps: int,
                 batch_size: int) -> None:  # thread: worker
        """Put each step's batch, then ``stop``; give up once the consumer
        is gone (``done`` set)."""
        items = ((s, self.get_batch(s, batch_size))
                 for s in range(start_step, start_step + num_steps))
        for item in itertools.chain(items, [stop]):
            while not done.is_set():
                try:
                    q.put(item, timeout=_PUT_WAIT_S)
                    break
                except queue.Full:
                    continue
            if done.is_set():
                return

    def iter_batches(self, start_step: int, num_steps: int, batch_size: int,
                     prefetch: int = 2):
        """Background-thread prefetched iterator (host-side input
        pipeline) of (step, batch). The producer thread ends when the
        iterator is exhausted or dropped."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        done = threading.Event()
        stop = object()
        t = threading.Thread(target=self._produce, daemon=True,
                             args=(q, done, stop, start_step, num_steps,
                                   batch_size))
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                yield item
        finally:
            done.set()
            t.join()
