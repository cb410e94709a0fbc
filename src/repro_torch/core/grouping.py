"""Density-driven page grouping, §4.3 Algorithm 2 (port of
``repro.core.grouping``).

The build scans pages in storage order, OR-ing each page's bucket bitmap into
a working partial histogram; when its density exceeds the threshold D the
entry is cut (the triggering page is its last page) and a fresh working
histogram starts at the next page.

``page_bucket_bits`` runs on the device: one bucket-probe kernel launch over
every tuple, then a scatter into (P, H) bits. ``group_pages`` is the
reference's sequential ``lax.scan``; each step depends on the last, so here
it is a host loop over the packed page words, copied back once — per-page
device ops would be millions of launches at SF10. The loop holds each
bitmap as one Python int (``int.bit_count`` is the popcount) and compares
density in float32 exactly as the reference does: ``f32(count) / f32(H) >
f32(D)``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core.histogram import Histogram, bucketize


def tuple_bucket_ids(hist: Histogram, keys: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """The bucket each tuple of (P, C) ``keys`` sets in its page's bitmap:
    (P*C,) int64, one bucket-probe launch.

    As in the reference, an invalid tuple sets bucket H-1: its
    ``page_bucket_bits`` scatters invalid tuples at index -1 under
    ``mode="drop"``, and JAX wraps a negative index before it drops, so -1
    lands on H-1 (a page with a deleted tuple, or the padding of a partial
    last page, keeps bucket H-1 in its summary; ROADMAP.md, faults).
    """
    ids = bucketize(hist, keys.reshape(-1)).to(torch.int64)
    return torch.where(valid.reshape(-1), ids, hist.resolution - 1)


def page_bucket_bits(hist: Histogram, keys: torch.Tensor, valid: torch.Tensor,
                     resolution: int) -> torch.Tensor:
    """Per-page bucket membership: (num_pages, H) bool on ``keys.device``.

    keys/valid: (num_pages, page_card); invalid tuples set bucket H-1, as in
    the reference (``tuple_bucket_ids``).
    """
    num_pages, page_card = keys.shape
    ids = tuple_bucket_ids(hist, keys, valid)                      # (N,)
    page = torch.arange(num_pages * page_card, device=keys.device) // page_card
    flat = page * resolution + ids
    bits = torch.zeros((num_pages, resolution), dtype=torch.bool,
                       device=keys.device)
    bits.view(-1)[flat] = True
    return bits


def _cut_count(resolution: int, density: float) -> int:
    """Smallest popcount whose float32 density exceeds the threshold
    (resolution + 1 if none does)."""
    counts = np.arange(resolution + 1, dtype=np.float32)
    dens = counts / np.float32(resolution)
    over = np.flatnonzero(dens > np.float32(density))
    return int(over[0]) if over.size else resolution + 1


def group_pages(page_words: np.ndarray, resolution: int, density: float
                ) -> tuple[np.ndarray, np.ndarray]:
    """Algorithm 2 grouping scan on the host.

    page_words: (num_pages, W) uint32 packed page bitmaps. Returns
    (cut_flags (num_pages,) bool, entry_words (E, W) uint32): entry i's
    bitmap is the working histogram after absorbing the i-th flagged page —
    the reference's ``merged_bits`` at its cut pages. The last page always
    closes an entry.
    """
    num_pages, w = page_words.shape
    flags = np.zeros((num_pages,), bool)
    if num_pages == 0:
        return flags, np.zeros((0, w), np.uint32)
    cut = _cut_count(resolution, density)
    row = 4 * w
    raw = np.ascontiguousarray(page_words, dtype="<u4").tobytes()
    entries = []
    acc = 0
    for p in range(num_pages):
        acc |= int.from_bytes(raw[p * row:(p + 1) * row], "little")
        if acc.bit_count() >= cut:
            flags[p] = True
            entries.append(acc)
            acc = 0
    if not flags[-1]:
        flags[-1] = True
        entries.append(acc)
    words = b"".join(e.to_bytes(row, "little") for e in entries)
    return flags, np.frombuffer(words, dtype="<u4").reshape(-1, w).copy()


def finalize_entries(flags: np.ndarray, entry_words: np.ndarray
                     ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts, ends, entry_bitmaps_packed) from the grouping scan (the
    reference's host finalize; bitmaps arrive packed already)."""
    flags = np.asarray(flags)
    ends = np.flatnonzero(flags).astype(np.int32)
    starts = np.concatenate([[0], ends[:-1] + 1]).astype(np.int32)
    return starts, ends, np.asarray(entry_words, np.uint32)


def page_words_host(bits: torch.Tensor) -> np.ndarray:
    """Pack (P, H) page bits on their device, copy back once: (P, W) uint32."""
    return bm.from_bool(bits).cpu().numpy().view(np.uint32)
