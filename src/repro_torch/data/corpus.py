"""Paged training corpus with per-sequence metadata (port of
``repro.data.corpus``; numpy, the same corpus for the same seed).

The corpus is stored exactly like a Hippo-indexed table: sequences live in
fixed-size *pages* (``page_card`` sequences per page), and a metadata key
(quality score) is the indexed attribute. This is the paper's structure
deployed as the training data plane: sample-selection predicates ("quality in
[0.8, 1]") run through the Hippo access path instead of a corpus scan.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.storage.table import PagedTable


@dataclass
class PagedCorpus:
    tokens: np.ndarray          # (num_seqs, seq_len) int32
    quality: np.ndarray         # (num_seqs,) float32 — the indexed attribute
    domain: np.ndarray          # (num_seqs,) int32
    table: PagedTable           # quality scores in paged layout
    page_card: int

    @property
    def num_seqs(self) -> int:
        return self.tokens.shape[0]

    def seq_ids_for_pages(self, page_ids: np.ndarray) -> np.ndarray:
        """Sequence ids stored in the given pages (page p holds sequences
        [p*page_card, (p+1)*page_card))."""
        ids = (page_ids[:, None] * self.page_card
               + np.arange(self.page_card)[None, :]).ravel()
        return ids[ids < self.num_seqs]


def synthesize_corpus(num_seqs: int, seq_len: int, vocab_size: int,
                      page_card: int = 64, seed: int = 0,
                      shard_run: int = 512) -> PagedCorpus:
    """Synthetic corpus with a learnable structure per domain, plus a quality
    score correlated with domain.

    Sequences arrive in *shard runs* (``shard_run`` contiguous sequences per
    domain), the way crawl dumps and curated subsets land in real ingestion —
    this storage locality is what lets a page-range index prune (the same
    assumption behind BRIN/zone maps; Hippo additionally tolerates the
    within-run skew via histograms)."""
    rng = np.random.default_rng(seed)
    n_runs = (num_seqs + shard_run - 1) // shard_run
    run_domain = rng.integers(0, 4, n_runs)
    domain = np.repeat(run_domain, shard_run)[:num_seqs].astype(np.int32)
    quality = (0.25 * domain + rng.uniform(0, 0.25, num_seqs)).astype(np.float32)
    base = rng.integers(0, vocab_size, (num_seqs, seq_len), dtype=np.int32)
    # cheap structure: domain d walks tokens with stride d+1
    stride = (domain[:, None] + 1).astype(np.int32)
    ramp = np.arange(seq_len, dtype=np.int32)[None, :]
    tokens = (base[:, :1] + stride * ramp) % vocab_size
    table = PagedTable.from_values(quality, page_card=page_card, spare_pages=16)
    return PagedCorpus(tokens=tokens.astype(np.int32), quality=quality,
                       domain=domain, table=table, page_card=page_card)
