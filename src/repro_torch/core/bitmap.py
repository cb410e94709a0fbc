"""Packed bitmap primitives for Hippo partial histograms (port of
``repro.core.bitmap``).

Bitmaps are fixed-width packed words over the H buckets of the complete
histogram: bit ``b`` of word ``w`` is bucket ``w*32 + b``. The reference
packs into uint32; here the words are **int32 tensors holding the same
bits**, because PyTorch's CPU kernels do not shift uint32 (``>>`` raises
"rshift_cpu not implemented for 'UInt32'"). Right shifts on int32 are
arithmetic, so every bit extraction masks after shifting, and packing goes
through int64 so bit 31 lands as the sign bit. ``words.view(np.uint32)`` on
the host (or ``.numpy().view(np.uint32)``) gives the reference's words back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

WORD_BITS = 32


def num_words(num_bits: int) -> int:
    """Words needed to hold ``num_bits`` bits."""
    return (num_bits + WORD_BITS - 1) // WORD_BITS


def zeros(num_bits: int, *leading: int, device=None) -> torch.Tensor:
    """An all-zero packed bitmap with optional leading batch dims."""
    return torch.zeros((*leading, num_words(num_bits)), dtype=torch.int32,
                       device=resolve_device(device))


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def from_bool(bits: torch.Tensor) -> torch.Tensor:
    """Pack a (..., H) bool tensor into (..., ceil(H/32)) int32 words.

    One pass per bit position over (..., W) int64 accumulators, so memory
    stays at the size of the words, not 32x the bits.
    """
    h = bits.shape[-1]
    w = num_words(h)
    pad = w * WORD_BITS - h
    if pad:
        bits = torch.cat([bits, bits.new_zeros((*bits.shape[:-1], pad))],
                         dim=-1)
    bits = bits.reshape(*bits.shape[:-1], w, WORD_BITS)
    acc = torch.zeros(bits.shape[:-1], dtype=torch.int64, device=bits.device)
    for b in range(WORD_BITS):
        acc |= bits[..., b].to(torch.int64) << b
    return _wrap_int32(acc)


def to_bool(words: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Unpack (..., W) int32 words to a (..., num_bits) bool tensor."""
    shifts = torch.arange(WORD_BITS, dtype=torch.int32, device=words.device)
    bits = (words[..., :, None] >> shifts) & 1
    bits = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return bits[..., :num_bits].to(torch.bool)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-bitmap population count over the trailing word axis (int32)."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) >> 24) & 0xFF
    return x.sum(dim=-1).to(torch.int32)


def density(words: torch.Tensor, num_bits: int) -> torch.Tensor:
    """Partial histogram density (§4.3): kept buckets / total buckets, in
    float32 as the reference divides (``f32(popcount) / f32(H)``)."""
    return popcount(words).to(torch.float32) / float(num_bits)


def _bit_word(idx: int) -> int:
    """The int32 word holding only bit ``idx % 32`` (bit 31 wraps)."""
    b = idx % WORD_BITS
    return (1 << b) - (1 << 32 if b == WORD_BITS - 1 else 0)


def set_bit(words: torch.Tensor, idx: int) -> torch.Tensor:
    """A copy of ``words`` with bit ``idx`` set in the trailing word axis."""
    out = words.clone()
    out[..., idx // WORD_BITS] |= _bit_word(idx)
    return out


def get_bit(words: torch.Tensor, idx: int) -> torch.Tensor:
    """Bit ``idx`` of the trailing word axis, as 0/1 int32."""
    return (words[..., idx // WORD_BITS] >> (idx % WORD_BITS)) & 1


def union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a | b


def or_reduce(words: torch.Tensor) -> torch.Tensor:
    """OR of the rows of (N, W) words: (W,), on their device. PyTorch has no
    bitwise-or reduction, so rows are OR-ed pairwise, halving N each step
    (log2 N steps, twice the words' bytes in all)."""
    x = words
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[1:])
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        y = x[:half] | x[half:2 * half]
        if x.shape[0] % 2:
            y[0] |= x[-1]
        x = y
    return x[0].clone()


def any_joint(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """True where bitmaps share at least one set bit (joint buckets, §3.2).

    Broadcasts over leading dims; reduces the trailing word axis.
    """
    return ((a & b) != 0).any(dim=-1)


def range_mask(num_bits: int, lo: torch.Tensor, hi: torch.Tensor
               ) -> torch.Tensor:
    """Packed bitmaps with bits [lo, hi] (inclusive) set, one per element of
    the (...,) int tensors ``lo``/``hi``: (..., W) int32."""
    idx = torch.arange(num_words(num_bits) * WORD_BITS, dtype=torch.int64,
                       device=lo.device)
    bits = ((idx >= lo[..., None]) & (idx <= hi[..., None])
            & (idx < num_bits))
    return from_bool(bits)


# ---------------------------------------------------------------------------
# Serialization-boundary compression (host numpy, copied from the reference)
# ---------------------------------------------------------------------------

def rle_compress(words: np.ndarray) -> np.ndarray:
    """Word-level RLE of a 1-D uint32 word array: interleaved (count, word)
    pairs of the runs of identical words."""
    words = np.asarray(words, dtype=np.uint32).ravel()
    if words.size == 0:
        return np.zeros((0,), dtype=np.uint32)
    change = np.flatnonzero(np.diff(words)) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [words.size]])
    counts = (ends - starts).astype(np.uint32)
    return np.stack([counts, words[starts]], axis=1).ravel()


def compressed_nbytes(words: np.ndarray) -> int:
    """Size in bytes of the RLE-compressed form (paper's storage metric)."""
    return int(rle_compress(words).nbytes)


def rle_decompress(pairs: np.ndarray) -> np.ndarray:
    """Inverse of ``rle_compress``: the words of interleaved (count, word)
    pairs."""
    pairs = np.asarray(pairs, dtype=np.uint32).reshape(-1, 2)
    return np.repeat(pairs[:, 1], pairs[:, 0])


def rle_encode_rows(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    """Each row of (n, W) uint32 words as the smaller of its raw words and
    its ``rle_compress`` pairs, in one vectorized pass: (flags u8 (n,), 1
    where the row is RLE; lens u32 (n,), the words each row stores; data
    u32, the rows' streams in row order). A row has 1 + #{j : w[j] !=
    w[j-1]} runs and takes the RLE form iff twice that is below W. The same
    bytes as the reference snapshot's per-entry loop."""
    rows = np.asarray(rows, np.uint32)
    n, w = rows.shape
    change = rows[:, 1:] != rows[:, :-1]                      # (n, W-1)
    runs = 1 + change.sum(axis=1)
    rle = 2 * runs < w
    lens = np.where(rle, 2 * runs, w).astype(np.uint32)
    ends = np.cumsum(lens, dtype=np.int64)
    offs = ends - lens
    data = np.empty((int(ends[-1]) if n else 0,), np.uint32)
    raw = np.flatnonzero(~rle)
    data[(offs[raw, None] + np.arange(w)).ravel()] = rows[raw].ravel()
    r = np.flatnonzero(rle)
    if r.size:
        starts = np.concatenate(
            [np.ones((r.size, 1), bool), change[r]], axis=1)   # run starts
        row, col = np.nonzero(starts)                  # row-major order
        nxt = np.append(col[1:], w)
        last = np.append(row[1:] != row[:-1], True)    # a row's final run
        counts = np.where(last, w, nxt) - col
        first = np.cumsum(runs[r]) - runs[r]           # run index of row
        k = np.arange(row.size) - first[row]
        pos = offs[r][row] + 2 * k
        data[pos] = counts
        data[pos + 1] = rows[r][row, col]
    return rle.astype(np.uint8), lens, data


def rle_decode_rows(flags: np.ndarray, lens: np.ndarray, data: np.ndarray,
                    words: int) -> np.ndarray:
    """Inverse of ``rle_encode_rows``: (n, words) uint32. Refuses, as the
    reference's loop does, data shorter than the lengths claim and a row
    that decodes to another word count (``CorruptSnapshotError``),
    whichever row fails first."""
    from repro_torch.checkpointing.layout import CorruptSnapshotError
    flags = np.asarray(flags).astype(bool)
    lens = np.asarray(lens, np.int64)
    data = np.asarray(data, np.uint32)
    n = flags.shape[0]
    ends = np.cumsum(lens)
    offs = ends - lens
    short = np.flatnonzero(ends > data.size)
    first_short = int(short[0]) if short.size else n
    ok = np.arange(n) < first_short
    # words each complete row decodes to: its length raw, its counts RLE
    got = lens.copy()
    r = np.flatnonzero(flags & ok)
    odd = (lens[r] % 2).astype(bool)
    npairs = lens[r] // 2
    first = np.cumsum(npairs) - npairs                 # pair index of row
    pairs_row = np.repeat(np.arange(r.size), npairs)
    pair_pos = (offs[r][pairs_row]
                + 2 * (np.arange(pairs_row.size) - first[pairs_row]))
    counts = data[pair_pos].astype(np.int64)
    csum = np.concatenate([[0], np.cumsum(counts)])
    got[r] = csum[first + npairs] - csum[first]
    got[r[odd]] = -1                          # not whole (count, word) pairs
    bad = np.flatnonzero(ok & (got != words))
    if bad.size:
        raise CorruptSnapshotError(
            f"entry bitmap decodes to {int(got[bad[0]])} words, index "
            f"resolution wants {words}")
    if first_short < n:
        raise CorruptSnapshotError(
            "bitmap section shorter than its per-entry lengths claim")
    out = np.empty((n, words), np.uint32)
    raw = np.flatnonzero(~flags)
    out[raw] = data[(offs[raw, None] + np.arange(words)).reshape(
        raw.size, words)]
    out[r] = np.repeat(data[pair_pos + 1], counts).reshape(r.size, words)
    return out
