"""The yardstick's arithmetic, frozen here: the index's bytes (a copy of the
program's ``index_nbytes`` accounting) and the bytes a kernel call must move
once, counted from the wrapper's argument shapes and the engine's counters.

A roofline share is (once-moved bytes / the published HBM rate) / measured
kernel time. Each input byte read once and each output byte written once;
what a kernel reads again is not counted.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s (dense rates, 700 W).
PEAK_HBM_BYTES_PER_S = 3.35e12


def index_nbytes(num_entries, live_slots, words: int, bounds_len: int,
                 num_shards: int) -> int:
    """Bytes of a sharded Hippo index as the paper counts them: per shard the
    live entries' bitmaps (``words`` int32 words each), two 4 B page ids and
    a 4 B sorted-list slot per entry, and the histogram's bounds; then 8 B
    of routing map and one summary bitmap per shard."""
    total = 0
    for e, live in zip(num_entries, live_slots):
        total += int(live) * words * 4 + int(e) * 8 + int(e) * 4 \
            + bounds_len * 4
    return total + num_shards * 8 + num_shards * words * 4


def compact_inspect_bytes(calls, pages_gathered: int, page_card: int) -> int:
    """Kernel B (``compact_inspect``), over calls ``(S, Q, M)``: the selected
    pages' keys (4 B) and valid bytes (1 B) read once (pad selections read
    nothing), ``sel`` (S, M) int32, ``sel_mask`` (S, Q, M) bytes, the Q
    endpoint pairs, and the (S, Q, M) int32 counts written."""
    fixed = sum(s * m * 4 + s * q * m * 1 + q * 8 + s * q * m * 4
                for s, q, m in calls)
    return fixed + pages_gathered * page_card * 5


def batch_filter_bytes(calls) -> int:
    """Kernel A (``batch_filter_sharded``), over calls ``(S, Q, E, W)``: the
    query words, every entry slot's words and live byte read once, and the
    (S, Q, E) match bytes written."""
    return sum(s * q * w * 4 + s * e * w * 4 + s * e + s * q * e
               for s, q, e, w in calls)


def roofline_percent(nbytes: int, device_seconds: float):
    """Share of the byte bound, in %; None where nothing ran."""
    if device_seconds <= 0 or nbytes <= 0:
        return None
    return nbytes / PEAK_HBM_BYTES_PER_S / device_seconds * 100.0
