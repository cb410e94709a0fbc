"""The one traffic generator: reads a mix file and the seed, and yields the
queries and the schedule of the refresh stream.

A mix file (``portbench/traffic/<name>.json``) holds only parameters:

  reads.loop          "closed" (``outstanding`` queries kept queued) or
                      "open" (Poisson arrivals at ``rate_qps``)
  reads.widths        predicate widths in days; each takes an equal share
  reads.recent_share  share of queries that end within the newest
                      ``recent_days`` days; the rest start uniformly over
                      every day loaded or appended so far, the days that
                      retention deleted included (their tuples must count
                      nothing)
  reads.top_k         row ids returned per query (0: counts only)
  writes              null, or {"rate_rows_per_s": r}: the configuration's
                      refresh stream (``portbench/streams/``) with Poisson
                      row arrivals at r rows a second

Every seed gets the same sizes and the same arrivals in another order: each
block of 64 queries holds every width equally often (and exactly
``recent_share`` of it recent), and the inter-arrival gaps are one fixed set
of exponential quantiles, shuffled by the seed.
"""
from __future__ import annotations

import math

import numpy as np

BLOCK = 64
READS, READ_GAPS, WRITE_GAPS = 1, 2, 3     # independent streams of a seed


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def poisson_gaps(rate: float, n: int, seed: int, stream: int) -> np.ndarray:
    """(n,) seconds between arrivals: the n quantiles (i + 0.5) / n of an
    exponential of mean 1 / rate, in a seeded order."""
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    return _rng(seed, stream).permutation(gaps)


def arrivals(rate: float, seconds: float, seed: int, stream: int
             ) -> np.ndarray:
    """Due times (seconds from the window's start) of the arrivals inside
    ``seconds``, from one set of gaps sized for the window."""
    n = int(math.ceil(rate * seconds * 1.25)) + 64
    due = np.cumsum(poisson_gaps(rate, n, seed, stream))
    return due[due < seconds]


class Queries:
    """The mix's queries in order. ``take(n, newest)`` returns the next n
    (lo, hi) pairs, inclusive whole days, placed on the days [0, newest]."""

    def __init__(self, mix: dict, seed: int):
        r = mix["reads"]
        self.widths = np.asarray(r["widths"], np.int64)
        if BLOCK % self.widths.size:
            raise ValueError(f"{self.widths.size} widths do not share a "
                             f"block of {BLOCK} equally")
        self.recent_days = int(r.get("recent_days", 30))
        self.n_recent = int(round(float(r.get("recent_share", 0.0)) * BLOCK))
        self._rng = _rng(seed, READS)
        self._w = np.zeros((0,), np.int64)
        self._recent = np.zeros((0,), bool)
        self._u = np.zeros((0,), np.float64)

    def _refill(self, n: int) -> None:
        blocks = -(-n // BLOCK)
        w = np.tile(np.repeat(self.widths, BLOCK // self.widths.size),
                    (blocks, 1))
        rec = np.tile(np.arange(BLOCK) < self.n_recent, (blocks, 1))
        w = self._rng.permuted(w, axis=1).ravel()
        rec = self._rng.permuted(rec, axis=1).ravel()
        u = self._rng.random(blocks * BLOCK)
        self._w = np.concatenate([self._w, w])
        self._recent = np.concatenate([self._recent, rec])
        self._u = np.concatenate([self._u, u])

    def take(self, n: int, newest) -> tuple[np.ndarray, np.ndarray]:
        if self._w.size < n:
            self._refill(n - self._w.size)
        w, rec, u = self._w[:n], self._recent[:n], self._u[:n]
        self._w, self._recent, self._u = self._w[n:], self._recent[n:], \
            self._u[n:]
        newest = np.broadcast_to(np.asarray(newest, np.int64), (n,))
        # uniform: lo over [0, newest - w + 1]
        span = np.maximum(newest - w + 2, 1)
        lo_uniform = np.floor(u * span).astype(np.int64)
        # recent: hi over the newest recent_days days
        hi_recent = newest - np.floor(u * self.recent_days).astype(np.int64)
        lo = np.where(rec, hi_recent - w + 1, lo_uniform)
        return lo, lo + w - 1
