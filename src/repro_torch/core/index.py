"""Hippo index — structure, build, search and maintenance (port of
``repro.core.index``).

State layout as in the reference, as tensors on one device; a sharded index
stacks every field along a leading shard axis (``core.partition``):

  bounds       (H+1,) f32   complete histogram boundaries
  bitmaps      (S, W) i32   partial histograms, packed (uint32 bits in int32)
  starts/ends  (S,)   i32   first / last page summarized by each slot
  sorted_order (S,)   i32   logical (page-ascending) position -> physical slot
  slot_live    (S,)   bool  false for slots abandoned by relocation
  num_entries, num_slots, summarized_until: 0-d i32

Algorithm 1 runs in three forms, each with an explicit shard axis where the
reference vmaps:

  search                the single query: joint-bucket filter
                        (``kernels.bitmap_and``), entry -> page expansion,
                        exact inspection with the tuple mask
                        (``kernels.page_inspect``)
  search_many[_sharded] the dense batch: the filter of every query
                        (``kernels.batch_filter``), the expansion, and
                        per-query counts over every selected page
                        (``kernels.page_inspect.page_inspect_many``, which
                        never forms the (Q, P, C) tuple mask)
  search_compact_many[_sharded]
                        the gather batch: the filter, the expansion, the
                        batch union selected into a fixed-size slab of page
                        ids, the fused inspect (``kernels.compact_inspect``,
                        which reads pages through the selection and makes no
                        slab copy) and, with ``top_k``, row ids derived from
                        the kernel's per-(query, page) counts

Maintenance (§5) returns new states and never writes into the one it was
given (a caller may hold it as a rollback snapshot):

  insert_tuples         Algorithm 3 for a run of tuples: one bucket-probe
                        launch for the run and one copy of the scalars and the
                        last entry to the host, the branches (set a bit in
                        place or relocate; extend or create) replayed on host
                        mirrors, then one scatter per field. ``insert_tuple``
                        is the run of one.
  insert_batch_existing the batch path for tuples on summarized pages: one
                        sorted-list search for every tuple, then the OR of the
                        deduplicated (slot, word, bit) triples
  resummarize_slots     vacuum (§5.2): the affected entries' page ranges, as
                        the reference assigns them, re-bucketized and OR-ed
                        into fresh bitmaps the same way
  resummarize_shard     the same for every live entry under new bounds

The writer's staged overlay (``staged_overlay_counts``) adds the rows a
``runtime.writer.MaintenanceWriter`` holds staged to the counts of
``search_many_sharded_staged`` and ``search_compact_many_sharded_staged``;
staged rows occupy no page yet, so they never enter row ids, page masks or
``truncated``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import grouping
from repro_torch.core.histogram import Histogram, bucketize
from repro_torch.kernels.batch_filter import batch_filter, batch_filter_sharded
from repro_torch.kernels.bitmap_and import bitmap_and_any
from repro_torch.kernels.compact_inspect import compact_inspect
from repro_torch.kernels.page_inspect import page_inspect, page_inspect_many
from repro_torch.spans import span

_INT32_MAX = np.iinfo(np.int32).max


@dataclass(frozen=True)
class HippoConfig:
    resolution: int = 400          # H — complete histogram resolution
    density: float = 0.2           # D — partial histogram density threshold
    page_card: int = 50            # tuples per page
    max_slots: int = 1 << 14       # physical entry capacity
    relocate_on_update: bool = True  # model §5.1 out-of-place updates

    @property
    def words(self) -> int:
        return bm.num_words(self.resolution)


class HippoState(NamedTuple):
    bounds: torch.Tensor        # (H+1,) f32
    bitmaps: torch.Tensor       # (S, W) i32
    starts: torch.Tensor        # (S,) i32
    ends: torch.Tensor          # (S,) i32
    sorted_order: torch.Tensor  # (S,) i32
    slot_live: torch.Tensor     # (S,) bool
    num_entries: torch.Tensor   # i32 scalar
    num_slots: torch.Tensor     # i32 scalar
    summarized_until: torch.Tensor  # i32 scalar

    @property
    def histogram(self) -> Histogram:
        return Histogram(self.bounds)


class SearchResult(NamedTuple):
    """Result of the single-query ``search`` (fields as in the reference)."""
    count: torch.Tensor            # i32 scalar — qualified tuple count
    qualified: torch.Tensor        # (num_pages, page_card) bool
    page_mask: torch.Tensor        # (num_pages,) bool
    pages_inspected: torch.Tensor  # i32 scalar
    entries_matched: torch.Tensor  # i32 scalar


class BatchSearchResult(NamedTuple):
    """Per-query results of ``search_many`` (query axis Q leads; no (Q, P, C)
    tuple mask, as in the reference)."""
    counts: torch.Tensor           # (Q,) i32
    page_mask: torch.Tensor        # (Q, num_pages) bool
    pages_inspected: torch.Tensor  # (Q,) i32
    entries_matched: torch.Tensor  # (Q,) i32


class CompactBatchResult(NamedTuple):
    """Per-query results of the compact search (fields as in the reference;
    see ``repro.core.index.CompactBatchResult``)."""
    counts: torch.Tensor           # (Q,) i32
    pages_inspected: torch.Tensor  # (Q,) i32
    entries_matched: torch.Tensor  # (Q,) i32
    truncated: torch.Tensor        # (Q,) bool
    bucket_needed: torch.Tensor    # i32 scalar
    pages_selected: torch.Tensor   # i32 scalar
    pages_gathered: torch.Tensor   # i32 scalar
    row_ids: torch.Tensor          # (Q, top_k) i32, ascending, -1 padded


# ---------------------------------------------------------------------------
# Build (§4, Algorithm 2)
# ---------------------------------------------------------------------------

def build(cfg: HippoConfig, hist: Histogram, keys: torch.Tensor,
          valid: torch.Tensor) -> HippoState:
    """Initialize Hippo over a paged key column on ``keys.device``.

    Device: bucket probe + page bits; host: the grouping scan and entry
    extraction. Returns a fixed-capacity ``HippoState``.
    """
    num_pages = keys.shape[0]
    if num_pages == 0:
        starts = ends = np.zeros((0,), np.int32)
        packed = np.zeros((0, cfg.words), np.uint32)
    else:
        bits = grouping.page_bucket_bits(hist, keys, valid, cfg.resolution)
        flags, entry_words = grouping.group_pages(
            grouping.page_words_host(bits), cfg.resolution, cfg.density)
        starts, ends, packed = grouping.finalize_entries(flags, entry_words)
    e = starts.shape[0]
    if e > cfg.max_slots:
        raise ValueError(f"built {e} entries > max_slots {cfg.max_slots}; raise capacity")
    s, w = cfg.max_slots, cfg.words
    bitmaps = np.zeros((s, w), np.uint32)
    bitmaps[:e] = packed
    st = np.full((s,), _INT32_MAX, np.int32)
    st[:e] = starts
    en = np.full((s,), _INT32_MAX, np.int32)
    en[:e] = ends
    live = np.zeros((s,), bool)
    live[:e] = True
    dev = keys.device

    def t(a):
        return torch.from_numpy(a).to(dev)

    def scalar(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    return HippoState(
        bounds=hist.bounds.to(dev),
        bitmaps=t(bitmaps.view(np.int32)),
        starts=t(st),
        ends=t(en),
        sorted_order=torch.arange(s, dtype=torch.int32, device=dev),
        slot_live=t(live),
        num_entries=scalar(e),
        num_slots=scalar(e),
        summarized_until=scalar(num_pages - 1 if e else -1),
    )


def stack_states(states: list[HippoState]) -> HippoState:
    """Stack per-shard states along a leading shard axis."""
    return HippoState(*(torch.stack([st[i] for st in states])
                        for i in range(len(HippoState._fields))))


def _one_shard(state: HippoState) -> HippoState:
    """An unsharded state as a stack of one shard (views, no copy)."""
    return HippoState(*(f[None] for f in state))


def shard_state(shards: HippoState, s: int) -> HippoState:
    """Shard s of a stacked state (views, no copy)."""
    return HippoState(*(f[s] for f in shards))


# ---------------------------------------------------------------------------
# Search (§3, Algorithm 1): the steps every form shares
# ---------------------------------------------------------------------------

def _live_slots(shards: HippoState) -> torch.Tensor:
    """(S, E) bool: live slots below each shard's ``num_slots``."""
    e = shards.slot_live.shape[1]
    slot = torch.arange(e, dtype=torch.int32, device=shards.slot_live.device)
    return (shards.slot_live & (slot[None, :] < shards.num_slots[:, None])
            ).contiguous()


def _logical_starts(shards: HippoState) -> torch.Tensor:
    """(S, E) starts in logical (sorted-list) order, padded with INT32_MAX."""
    e = shards.sorted_order.shape[1]
    pos = torch.arange(e, dtype=torch.int32, device=shards.starts.device)
    starts = shards.starts.gather(1, shards.sorted_order.long())
    return torch.where(pos[None, :] < shards.num_entries[:, None], starts,
                       _INT32_MAX).contiguous()


def _expand_page_mask(shards: HippoState, match: torch.Tensor,
                      num_pages: int) -> torch.Tensor:
    """Matched entries -> page masks (Bitmap b of Algorithm 1).

    Live entries partition each shard's summarized pages contiguously in
    logical order, so every page has at most one owning entry: binary-search
    each page's logical position once, then gather the owner's match bit per
    query. Pages past the last entry's ``end`` stay False. match: (S, Q, E)
    bool -> (S, Q, num_pages) bool.
    """
    s, q, _ = match.shape
    ls = _logical_starts(shards)
    pages = torch.arange(num_pages, dtype=torch.int32, device=match.device)
    pages = pages[None, :].expand(s, num_pages).contiguous()
    pos = torch.searchsorted(ls, pages, right=True).long() - 1
    slot = shards.sorted_order.gather(1, pos.clamp(min=0)).long()
    in_range = (pos >= 0) & (pages <= shards.ends.gather(1, slot))
    owner = slot[:, None, :].expand(s, q, num_pages)
    return torch.gather(match, 2, owner) & in_range[:, None, :]


def _pages_global(page_mask: torch.Tensor) -> torch.Tensor:
    """(S, Q, PPS) per-shard page masks -> (Q, S*PPS) in global page order."""
    s, q, pps = page_mask.shape
    return page_mask.permute(1, 0, 2).reshape(q, s * pps)


# ---------------------------------------------------------------------------
# Single-query and dense batch search
# ---------------------------------------------------------------------------

def locate_slots(state: HippoState, page_ids: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``locate_slot`` for a tensor of pages: one binary search of the
    sorted list for all of them. Returns (physical_slots, logical_pos), int32
    tensors of ``page_ids``' shape."""
    ls = _logical_starts(_one_shard(state))[0]
    pages = page_ids.to(device=ls.device, dtype=torch.int32).reshape(-1)
    pos = (torch.searchsorted(ls, pages, right=True) - 1).clamp(min=0)
    slots = state.sorted_order[pos]
    return (slots.reshape(page_ids.shape),
            pos.to(torch.int32).reshape(page_ids.shape))


def locate_slot(state: HippoState, page_id) -> tuple[torch.Tensor,
                                                     torch.Tensor]:
    """Binary search the sorted list for the entry owning ``page_id`` (§5.3).

    Returns (physical_slot, logical_pos) as 0-d int32 tensors. The caller
    guarantees the page is summarized (page_id <= summarized_until).
    """
    page = torch.as_tensor(page_id, dtype=torch.int32,
                           device=state.starts.device)
    return locate_slots(state, page)


def search(state: HippoState, query_bitmap: torch.Tensor, keys: torch.Tensor,
           valid: torch.Tensor, lo, hi) -> SearchResult:
    """Algorithm 1 for one predicate: the joint-bucket filter of every entry
    (``bitmap_and``, live mask fused), the expansion of matched entries to
    pages, and the exact inspection of those pages (``page_inspect``, which
    also gives the tuple mask). keys/valid: (P, C); query_bitmap (W,) int32;
    lo/hi: the interval, float32 scalars. Every field equals the
    reference's ``search`` bit for bit."""
    num_pages = keys.shape[0]
    match = bitmap_and_any(state.bitmaps, query_bitmap.contiguous(),
                           _live_slots(_one_shard(state))[0])       # (E,)
    page_mask = _expand_page_mask(_one_shard(state), match[None, None],
                                  num_pages)[0, 0]                  # (P,)
    qualified, counts = page_inspect(keys, valid, page_mask, lo, hi)
    return SearchResult(
        count=counts.sum(dtype=torch.int32),
        qualified=qualified,
        page_mask=page_mask,
        pages_inspected=page_mask.sum(dtype=torch.int32),
        entries_matched=match.sum(dtype=torch.int32),
    )


def search_many(state: HippoState, query_bitmaps: torch.Tensor,
                keys: torch.Tensor, valid: torch.Tensor, los: torch.Tensor,
                his: torch.Tensor) -> BatchSearchResult:
    """Algorithm 1 over a batch of Q predicates: the filter of every query
    against every entry (``batch_filter``), the expansion, and per-query
    counts over each query's pages (``page_inspect_many``). query_bitmaps
    (Q, W) int32; los/his (Q,) f32. Row q equals the reference's
    ``search_many`` row, and the ``search`` scalars of predicate q."""
    num_pages = keys.shape[0]
    match = batch_filter(query_bitmaps.contiguous(), state.bitmaps,
                         _live_slots(_one_shard(state))[0])         # (Q, E)
    page_mask = _expand_page_mask(_one_shard(state), match[None],
                                  num_pages)                        # (1, Q, P)
    counts = page_inspect_many(keys[None], valid[None],
                               page_mask.contiguous(), los, his)     # (1, Q)
    return BatchSearchResult(
        counts=counts[0],
        page_mask=page_mask[0],
        pages_inspected=page_mask[0].sum(dim=1, dtype=torch.int32),
        entries_matched=match.sum(dim=1, dtype=torch.int32),
    )


# ---------------------------------------------------------------------------
# Placed slabs (``launch.shardings.place_sharded`` on a mesh of d > 1 entries)
# ---------------------------------------------------------------------------

def _on_blocks(fn, shards: HippoState, query_bitmaps, keys, valid, los, his,
               **kw) -> list:
    """Run the unplaced sharded search ``fn`` once per distinct shard block of
    placed slabs (``PlacedTensor``s), where the block lives: each placed
    argument gives its block, a plain one (the (S, Q, W) query bitmaps,
    los/his) is sliced and copied there. Returns [(first shard, result)] in
    shard order."""
    out = []
    for sl, pos in keys.distinct_blocks():
        rows = sl[0]
        dev = keys.block(pos).device

        def block(t):
            if isinstance(t, torch.Tensor):
                return t[rows].to(dev)
            return t.block(pos)

        st = HippoState(*map(block, shards))
        out.append((rows.start, fn(st, block(query_bitmaps), keys.block(pos),
                                   valid.block(pos), los.to(dev), his.to(dev),
                                   **kw)))
    return out


def _total(parts) -> torch.Tensor:
    """Sum of per-block int32 results on the first block's device (the
    reference's cross-device psum)."""
    parts = list(parts)
    dev = parts[0].device
    return torch.stack([p.to(dev) for p in parts]).sum(dim=0,
                                                       dtype=torch.int32)


def _compact_on_blocks(shards: HippoState, query_bitmaps, keys, valid, los,
                       his, *, max_selected: int, top_k: int
                       ) -> CompactBatchResult:
    """``search_compact_many_sharded`` over placed slabs: each block's
    result, combined on the first block's device as the stacked call
    combines its shards (sums, OR, max; row ids offset by the block's first
    shard and merged ascending)."""
    res = _on_blocks(search_compact_many_sharded, shards, query_bitmaps, keys,
                     valid, los, his, max_selected=max_selected, top_k=top_k)
    dev = res[0][1].counts.device
    rows_per_shard = keys.shape[1] * keys.shape[2]
    gids = [torch.where(r.row_ids >= 0,
                        r.row_ids.to(dev).long() + s0 * rows_per_shard,
                        _INT32_MAX) for s0, r in res]
    merged = torch.cat(gids, dim=1).sort(dim=1).values[:, :top_k]
    return CompactBatchResult(
        counts=_total(r.counts for _, r in res),
        pages_inspected=_total(r.pages_inspected for _, r in res),
        entries_matched=_total(r.entries_matched for _, r in res),
        truncated=torch.stack([r.truncated.to(dev) for _, r in res]).any(dim=0),
        bucket_needed=torch.stack([r.bucket_needed.to(dev)
                                   for _, r in res]).max(),
        pages_selected=_total(r.pages_selected for _, r in res),
        pages_gathered=_total(r.pages_gathered for _, r in res),
        row_ids=torch.where(merged < _INT32_MAX, merged, -1).to(torch.int32),
    )


def search_many_sharded(shards: HippoState, query_bitmaps: torch.Tensor,
                        keys: torch.Tensor, valid: torch.Tensor,
                        los: torch.Tensor, his: torch.Tensor
                        ) -> BatchSearchResult:
    """``search_many`` over S shards, count-reduced (the fused dense path).

    query_bitmaps (S, Q, W), row s converted under shard s's bounds;
    keys/valid (S, PPS, C) slabs with slab-local entry page ids. Counts and
    match statistics sum over shards; ``page_mask`` is in global page order,
    (Q, S*PPS), as in the reference. Placed slabs and state
    (``launch.shardings.place_sharded`` on a mesh of more than one entry)
    run once per shard block where it lives, summed on the first block's
    device, with the same results.
    """
    if not isinstance(keys, torch.Tensor):
        res = _on_blocks(search_many_sharded, shards, query_bitmaps, keys,
                         valid, los, his)
        return BatchSearchResult(
            counts=_total(r.counts for _, r in res),
            page_mask=torch.cat([r.page_mask.to(res[0][1].counts.device)
                                 for _, r in res], dim=1),
            pages_inspected=_total(r.pages_inspected for _, r in res),
            entries_matched=_total(r.entries_matched for _, r in res))
    num_pages = keys.shape[1]
    match = batch_filter_sharded(query_bitmaps.contiguous(), shards.bitmaps,
                                 _live_slots(shards))                # (S, Q, E)
    page_mask = _expand_page_mask(shards, match, num_pages).contiguous()
    counts = page_inspect_many(keys, valid, page_mask, los, his)     # (S, Q)
    return BatchSearchResult(
        counts=counts.sum(dim=0, dtype=torch.int32),
        page_mask=_pages_global(page_mask),
        pages_inspected=page_mask.sum(dim=2, dtype=torch.int32).sum(
            dim=0, dtype=torch.int32),
        entries_matched=match.sum(dim=2, dtype=torch.int32).sum(
            dim=0, dtype=torch.int32),
    )


def staged_overlay_counts(staged_vals: torch.Tensor,
                          staged_live: torch.Tensor, los: torch.Tensor,
                          his: torch.Tensor) -> torch.Tensor:
    """Exact counts of staged-but-undrained rows per query: (Q,) int32, the
    rows v of ``staged_vals`` (S, B) f32 with ``staged_live`` set and
    lo <= v <= hi, summed over shards.

    The reference forms the (Q, S, B) compare; here each shard's live,
    non-NaN values are sorted into a prefix (the rest pushed past it as
    +inf) and two binary searches per (shard, query), clamped to the prefix
    length, give the same counts: a NaN value, a NaN endpoint and an empty
    interval (lo > hi) count nothing, as the compare does.
    """
    ok = staged_live & ~torch.isnan(staged_vals)
    n_ok = ok.sum(dim=1, keepdim=True)                            # (S, 1)
    srt = torch.where(ok, staged_vals, torch.inf).sort(dim=1).values
    s = srt.shape[0]
    lo = los[None, :].expand(s, -1).contiguous()
    hi = his[None, :].expand(s, -1).contiguous()
    upper = torch.searchsorted(srt, hi, right=True).clamp(max=n_ok)
    lower = torch.searchsorted(srt, lo).clamp(max=n_ok)
    n = (upper - lower).clamp(min=0)
    n = torch.where(torch.isnan(lo) | torch.isnan(hi), 0, n)       # (S, Q)
    return n.sum(dim=0, dtype=torch.int32)


def search_many_sharded_staged(shards: HippoState, query_bitmaps: torch.Tensor,
                               keys: torch.Tensor, valid: torch.Tensor,
                               los: torch.Tensor, his: torch.Tensor,
                               staged_vals: torch.Tensor,
                               staged_live: torch.Tensor) -> BatchSearchResult:
    """``search_many_sharded`` plus the staging-buffer overlay: counts gain
    the staged rows matching each predicate; ``page_mask``,
    ``pages_inspected`` and ``entries_matched`` stay index-only."""
    res = search_many_sharded(shards, query_bitmaps, keys, valid, los, his)
    return res._replace(counts=res.counts + staged_overlay_counts(
        staged_vals, staged_live, los, his))


# ---------------------------------------------------------------------------
# Compact batch search (gather-then-inspect)
# ---------------------------------------------------------------------------

def _select_union(union: torch.Tensor, max_selected: int) -> torch.Tensor:
    """(S, P) bool -> (S, M) int32: the first M set pages of each row in
    ascending order, padded with P (``jnp.nonzero(size=M, fill_value=P)``)."""
    s, p = union.shape
    pos = union.cumsum(dim=1) - 1
    idx = torch.where(union & (pos < max_selected), pos, max_selected)
    sel = torch.full((s, max_selected + 1), p, dtype=torch.int32,
                     device=union.device)
    pages = torch.arange(p, dtype=torch.int32, device=union.device)
    sel.scatter_(1, idx, pages[None, :].expand(s, p))
    return sel[:, :max_selected].contiguous()


def _first_row_ids(keys: torch.Tensor, valid: torch.Tensor, sel: torch.Tensor,
                   counts: torch.Tensor, los: torch.Tensor, his: torch.Tensor,
                   top_k: int) -> torch.Tensor:
    """Each shard's first ``top_k`` qualifying local row ids per query,
    ascending, -1 padded: (S, Q, top_k) int64.

    The reference ranks every position of a (Q, M*C) mask; here the kernel's
    per-(query, slab page) counts locate, per query, the at most ``top_k``
    slab pages that hold its first ``top_k`` matches (a count > 0 with fewer
    than ``top_k`` matches before it), and only those pages' C slots are
    inspected again.
    """
    s, p, c = keys.shape
    q, m = counts.shape[1], counts.shape[2]
    k = min(top_k, m)
    cnt = counts.long()
    need = (cnt > 0) & (cnt.cumsum(dim=2) - cnt < top_k)
    rank = need.cumsum(dim=2) - 1
    slot = torch.full((s, q, k + 1), m, dtype=torch.int64, device=keys.device)
    slab_pos = torch.arange(m, device=keys.device)[None, None, :].expand(s, q, m)
    slot.scatter_(2, torch.where(need, rank, k), slab_pos)
    slot = slot[:, :, :k]
    ok = slot < m
    page = sel.long().gather(1, slot.clamp(max=m - 1).reshape(s, q * k))
    page = torch.where(ok.reshape(s, q * k), page, 0)
    rows = page[:, :, None].expand(s, q * k, c)
    pk = keys.gather(1, rows).reshape(s, q, k * c)
    pv = valid.gather(1, rows).reshape(s, q, k * c)
    ok = ok[:, :, :, None].expand(s, q, k, c).reshape(s, q, k * c)
    qual = (ok & pv & (pk >= los[None, :, None]) & (pk <= his[None, :, None]))
    npos = k * c
    local = (page.reshape(s, q, k, 1) * c
             + torch.arange(c, device=keys.device)).reshape(s, q, npos)
    pos = torch.where(qual, torch.arange(npos, device=keys.device), npos)
    first = pos.sort(dim=2).values[:, :, :min(top_k, npos)]
    ids = torch.where(first < npos, local.gather(2, first.clamp(max=npos - 1)),
                      -1)
    if ids.shape[2] < top_k:
        ids = torch.nn.functional.pad(ids, (0, top_k - ids.shape[2]), value=-1)
    return ids


def search_compact_many_sharded(shards: HippoState, query_bitmaps: torch.Tensor,
                                keys: torch.Tensor, valid: torch.Tensor,
                                los: torch.Tensor, his: torch.Tensor, *,
                                max_selected: int, top_k: int = 0
                                ) -> CompactBatchResult:
    """Batched gather-then-inspect over S shards, count-reduced.

    shards: stacked ``HippoState``; query_bitmaps (S, Q, W) int32, row s
    converted under shard s's bounds; keys/valid (S, PPS, C) slabs (shard s
    owns global pages [s*PPS, (s+1)*PPS), entry page ids are slab-local);
    los/his (Q,) f32. ``max_selected`` is the per-shard slab width. Every
    field equals the reference's ``search_compact_many_sharded`` bit for bit:
    counts/pages_inspected/entries_matched sum over shards, ``truncated``
    ORs, ``bucket_needed`` is the largest per-shard union, and row ids are
    global (``s * PPS * C + local``) and merged ascending. Placed slabs and
    state run per shard block, as in ``search_many_sharded``.
    """
    if max_selected < 1:
        raise ValueError(f"max_selected must be >= 1, got {max_selected}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0, got {top_k}")
    if not isinstance(keys, torch.Tensor):
        return _compact_on_blocks(shards, query_bitmaps, keys, valid, los, his,
                                  max_selected=max_selected, top_k=top_k)
    s, num_pages, card = keys.shape
    q = query_bitmaps.shape[1]
    # Step 2, batched: joint-bucket test + page-range expansion per query.
    with span("hippo.index.filter"):
        match = batch_filter_sharded(query_bitmaps.contiguous(),
                                     shards.bitmaps,
                                     _live_slots(shards))            # (S, Q, E)
    with span("hippo.index.expand"):
        page_mask = _expand_page_mask(shards, match, num_pages)      # (S, Q, P)
    # Union across the batch: one slab of page ids serves every query.
    with span("hippo.index.select"):
        union = page_mask.any(dim=1)                                 # (S, P)
        n_union = union.sum(dim=1, dtype=torch.int32)                # (S,)
        sel = _select_union(union, max_selected)                     # (S, M)
        in_range = sel < num_pages
        idx = sel.clamp(max=num_pages - 1).long()[:, None, :].expand(
            s, q, max_selected)
        sel_mask = (torch.gather(page_mask, 2, idx)
                    & in_range[:, None, :]).contiguous()             # (S, Q, M)
    with span("hippo.index.inspect"):
        counts = compact_inspect(keys, valid, sel, sel_mask, los,
                                 his)                                # (S, Q, M)
    pages_inspected = page_mask.sum(dim=2, dtype=torch.int32)        # (S, Q)
    covered = sel_mask.sum(dim=2, dtype=torch.int32)
    if top_k:
        with span("hippo.index.row_ids"):
            ids = _first_row_ids(keys, valid, sel, counts, los, his, top_k)
            offs = torch.arange(s, device=keys.device) * num_pages * card
            gids = torch.where(ids >= 0, ids + offs[:, None, None],
                               _INT32_MAX)
            merged = gids.permute(1, 0, 2).reshape(q, -1).sort(dim=1).values
            merged = merged[:, :top_k]
            row_ids = torch.where(merged < _INT32_MAX, merged,
                                  -1).to(torch.int32)
    else:
        row_ids = torch.zeros((q, 0), dtype=torch.int32, device=keys.device)
    return CompactBatchResult(
        counts=counts.sum(dim=(0, 2), dtype=torch.int32),
        pages_inspected=pages_inspected.sum(dim=0, dtype=torch.int32),
        entries_matched=match.sum(dim=2, dtype=torch.int32).sum(
            dim=0, dtype=torch.int32),
        truncated=(covered < pages_inspected).any(dim=0),
        bucket_needed=n_union.max(),
        pages_selected=n_union.sum(dtype=torch.int32),
        pages_gathered=n_union.clamp(max=max_selected).sum(dtype=torch.int32),
        row_ids=row_ids,
    )


def search_compact_many_sharded_staged(shards: HippoState,
                                       query_bitmaps: torch.Tensor,
                                       keys: torch.Tensor, valid: torch.Tensor,
                                       los: torch.Tensor, his: torch.Tensor,
                                       staged_vals: torch.Tensor,
                                       staged_live: torch.Tensor, *,
                                       max_selected: int, top_k: int = 0
                                       ) -> CompactBatchResult:
    """``search_compact_many_sharded`` plus the staging-buffer overlay:
    counts gain the staged rows matching each predicate; row ids,
    ``pages_inspected`` and ``truncated`` stay index-only."""
    res = search_compact_many_sharded(shards, query_bitmaps, keys, valid,
                                      los, his, max_selected=max_selected,
                                      top_k=top_k)
    with span("hippo.index.overlay"):
        return res._replace(counts=res.counts + staged_overlay_counts(
            staged_vals, staged_live, los, his))


def search_compact_many(state: HippoState, query_bitmaps: torch.Tensor,
                        keys: torch.Tensor, valid: torch.Tensor,
                        los: torch.Tensor, his: torch.Tensor, *,
                        max_selected: int, top_k: int = 0
                        ) -> CompactBatchResult:
    """The unsharded compact search: one shard of
    ``search_compact_many_sharded`` (query_bitmaps (Q, W), keys (P, C))."""
    return search_compact_many_sharded(
        _one_shard(state), query_bitmaps[None], keys[None], valid[None],
        los, his, max_selected=max_selected, top_k=top_k)


def search_compact(state: HippoState, query_bitmap: torch.Tensor,
                   keys: torch.Tensor, valid: torch.Tensor, lo, hi,
                   max_selected: int):
    """The gather path for one predicate: ``search_compact_many`` at Q=1.

    Returns (count, pages_inspected, truncated) as 0-d tensors, equal to the
    reference's ``search_compact``: with ``truncated`` set the count covers
    only the first ``max_selected`` selected pages and the caller must fall
    back to the dense path.
    """
    dev = keys.device
    lo = torch.as_tensor(lo, dtype=torch.float32, device=dev).reshape(1)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=dev).reshape(1)
    res = search_compact_many(state, query_bitmap[None], keys, valid, lo, hi,
                              max_selected=max_selected)
    return res.counts[0], res.pages_inspected[0], res.truncated[0]


# ---------------------------------------------------------------------------
# Maintenance — eager insert (§5.1, Algorithm 3)
# ---------------------------------------------------------------------------

def _row_int(words: np.ndarray) -> int:
    """A bitmap's words (W,) as one Python int (bit b = bucket b)."""
    return int.from_bytes(np.ascontiguousarray(words).astype("<u4").tobytes(),
                          "little")


def _int_rows(rows, w: int) -> np.ndarray:
    """The inverse of ``_row_int`` for a list of ints: (k, W) int32."""
    raw = b"".join(x.to_bytes(4 * w, "little") for x in rows)
    return np.frombuffer(bytearray(raw), "<i4").reshape(-1, w)


class _Alg3:
    """Algorithm 3 replayed on host mirrors of one state.

    Holds the scalars, the last logical entry (slot, bitmap as a Python int,
    start, end), and every row (bitmap, start, end, liveness) and sorted-list
    position the replay wrote; a row it must read and has not written is
    copied from the state. ``state`` gives the new state: the writes applied
    to copies, one scatter per field.
    """

    def __init__(self, cfg: HippoConfig, state: HippoState, head: np.ndarray):
        self.cfg, self.old = cfg, state
        self.ne, self.ns, self.su, self.last = (int(x) for x in head[:4])
        self.lbits = _row_int(head[6:6 + cfg.words].view(np.uint32))
        self.lstart, self.lend = int(head[4]), int(head[5])
        self.bits: dict[int, int] = {}      # written rows
        self.starts: dict[int, int] = {}
        self.ends: dict[int, int] = {}
        self.live: dict[int, bool] = {}
        self.order: dict[int, int] = {}     # written sorted-list positions
        self.ne0 = self.ne
        self._logical = None                # initial logical starts, on demand

    def run(self, ids, pages, su_floor: int = -1, on_full=None) -> None:
        """Insert tuple k of bucket ``ids[k]`` on page ``pages[k]``, in
        order. With ``on_full``, a tuple that may take a slot (every tuple
        under relocation, else one past ``max(summarized_until,
        su_floor)``) while all ``max_slots`` are taken calls
        ``on_full(num_slots)``, which raises: the reference's check before
        each tuple. The last entry lives in locals: it takes nearly every
        tuple of an append."""
        cfg = self.cfg
        relocate, limit = cfg.relocate_on_update, cfg.max_slots
        h, dmax = np.float32(cfg.resolution), np.float32(cfg.density)
        bits, starts, ends, live, order = (self.bits, self.starts, self.ends,
                                           self.live, self.order)
        ne, ns, su, last = self.ne, self.ns, self.su, self.last
        lbits, lstart, lend = self.lbits, self.lstart, self.lend
        for b, p in zip(ids, pages):
            if on_full is not None and ns + 1 > limit and (
                    relocate or p > max(su, su_floor)):
                on_full(ns)
            bit = 1 << b
            if p > su:                           # new page: extend or create
                dens = (np.float32(lbits.bit_count()) / h if ne > 0
                        else np.float32(2.0))    # empty index: create
                if dens < dmax:
                    lbits |= bit
                    lend = p
                else:
                    bits[last], starts[last], ends[last] = lbits, lstart, lend
                    last, lbits, lstart, lend = ns, bit, p, p
                    live[last] = True
                    order[ne] = last
                    ne += 1
                    ns += 1
                su = p
            elif ne > 0 and p >= lstart:         # the last entry's page
                if lbits & bit:
                    continue                     # bit already set
                if relocate:
                    # §5.1: the updated entry moves to a new slot at the end
                    # of the index, the sorted list points at it (Fig. 4)
                    bits[last], starts[last], ends[last] = lbits, lstart, lend
                    live[last] = False
                    last = ns
                    live[last] = True
                    order[ne - 1] = last
                    ns += 1
                lbits |= bit
            else:                                # an earlier entry's page
                self.ne, self.ns, self.su, self.last = ne, ns, su, last
                self.lbits, self.lstart, self.lend = lbits, lstart, lend
                self._earlier(bit, p)
                ne, ns = self.ne, self.ns
        self.ne, self.ns, self.su, self.last = ne, ns, su, last
        self.lbits, self.lstart, self.lend = lbits, lstart, lend

    def _row(self, slot: int) -> tuple[int, int, int]:
        """Slot's (bitmap, start, end): written, else copied from the state."""
        if slot == self.last:
            return self.lbits, self.lstart, self.lend
        if slot not in self.bits:
            st = self.old
            self.bits[slot] = _row_int(st.bitmaps[slot].cpu().numpy())
            self.starts[slot] = int(st.starts[slot])
            self.ends[slot] = int(st.ends[slot])
        return self.bits[slot], self.starts[slot], self.ends[slot]

    def _earlier(self, bit: int, page: int) -> None:
        """A tuple on a page before the last entry's start (an insert never
        appends there, but ``insert_tuple`` allows it): locate the entry
        through the sorted list, whose starts never move (relocation keeps
        them, created entries append)."""
        if self._logical is None:
            ls = _logical_starts(_one_shard(self.old))[0]
            self._logical = ls.cpu().numpy()
        slot_at = [self.order[k] if k in self.order
                   else int(self.old.sorted_order[k])
                   for k in range(self.ne0, self.ne)]
        ls = np.concatenate([self._logical[: self.ne0],
                             [self._row(k)[1] for k in slot_at]])
        pos = max(int(np.searchsorted(ls, page, side="right")) - 1, 0)
        slot = self.order.get(pos)
        if slot is None:
            slot = int(self.old.sorted_order[pos])
        old, start, end = self._row(slot)
        if old & bit:
            return
        if not self.cfg.relocate_on_update:
            self.bits[slot] = old | bit
            return
        new = self.ns
        self.bits[new] = old | bit
        self.starts[new], self.ends[new] = start, end
        self.live[slot] = False
        self.live[new] = True
        self.order[pos] = new
        self.ns += 1

    def state(self) -> HippoState:
        st, w = self.old, self.cfg.words
        dev = st.bitmaps.device
        self.bits[self.last] = self.lbits
        self.starts[self.last] = self.lstart
        self.ends[self.last] = self.lend

        def put(t: torch.Tensor, writes: dict, vals=None) -> torch.Tensor:
            t = t.clone()
            if writes:
                idx = torch.tensor(list(writes), dtype=torch.int64, device=dev)
                if vals is None:
                    vals = np.fromiter(writes.values(), np.int64, len(writes))
                t[idx] = torch.from_numpy(vals).to(dev, t.dtype)
            return t

        def scalar(v: int) -> torch.Tensor:
            return torch.tensor(v, dtype=torch.int32, device=dev)

        return HippoState(
            bounds=st.bounds,
            bitmaps=put(st.bitmaps, self.bits,
                        _int_rows(self.bits.values(), w)),
            starts=put(st.starts, self.starts),
            ends=put(st.ends, self.ends),
            sorted_order=put(st.sorted_order, self.order),
            slot_live=put(st.slot_live, self.live,
                          np.fromiter(self.live.values(), bool,
                                      len(self.live))),
            num_entries=scalar(self.ne),
            num_slots=scalar(self.ns),
            summarized_until=scalar(self.su),
        )


def _head(state: HippoState) -> torch.Tensor:
    """(6 + W,) int32 on the state's device: num_entries, num_slots,
    summarized_until, the last logical entry's slot, start and end, and its
    bitmap words."""
    last = state.sorted_order[(state.num_entries.long() - 1).clamp(min=0)]
    li = last.long()
    return torch.cat([torch.stack([state.num_entries, state.num_slots,
                                   state.summarized_until, last,
                                   state.starts[li], state.ends[li]]),
                      state.bitmaps[li]])


def insert_tuples(cfg: HippoConfig, state: HippoState, values, page_ids, *,
                  ids: torch.Tensor | None = None, su_floor: int = -1,
                  on_full=None) -> tuple[HippoState, int]:
    """Algorithm 3 for tuples ``values`` on pages ``page_ids``, in order:
    the state after ``insert_tuple`` of each in turn, and its entry count.

    The values are bucketized in one bucket-probe launch (or ``ids`` gives
    their bucket ids, probed already); the ids come to the host with the
    scalars and the last entry in one copy, and the branches replay there
    (``_Alg3``): no device sync per tuple. ``on_full`` and ``su_floor`` are
    the capacity check before each tuple (``_Alg3.run``). The given state is
    never modified.
    """
    pages = np.asarray(page_ids, np.int64).reshape(-1)
    if pages.size == 0:
        return state, int(state.num_entries)
    if ids is None:
        if not isinstance(values, torch.Tensor):
            values = torch.from_numpy(np.asarray(values, np.float32))
        ids = bucketize(state.histogram, values.to(state.bitmaps.device))
    host = torch.cat([_head(state), ids]).cpu().numpy()
    rep = _Alg3(cfg, state, host)
    rep.run(host[6 + cfg.words:].tolist(), pages.tolist(), su_floor, on_full)
    return rep.state(), rep.ne


def insert_tuple(cfg: HippoConfig, state: HippoState, value,
                 page_id) -> HippoState:
    """Algorithm 3: eager single-tuple index update (§5.1): bucketize the
    value, locate the owning entry through the sorted list, then set the
    bucket bit (in place, or by relocation), extend the last entry, or open
    a new one, by the density rule."""
    return insert_tuples(cfg, state, [float(value)], [int(page_id)])[0]


def _or_bits(cfg: HippoConfig, rows: int, seg: torch.Tensor,
             ids: torch.Tensor) -> torch.Tensor:
    """(rows, W) int32 words with bucket ``ids[k]`` set in row ``seg[k]``
    for every k with 0 <= seg[k] < rows.

    The (row, word, bit) triples are deduplicated first (sorted as one int64
    key), so the sum of the distinct bits of a word, added into zeros, is
    their OR (bit 31 wraps in int32 as a sign, and distinct bits never
    carry). Memory: the keys (8 B a triple) and one (rows, W) word array;
    no (rows, H) table.
    """
    h, w = cfg.resolution, cfg.words
    seg = seg.long().reshape(-1)
    key = torch.where((seg >= 0) & (seg < rows),
                      seg * h + ids.long().reshape(-1), -1).sort().values
    keep = key >= 0
    keep[1:] &= key[1:] != key[:-1]
    b = key.remainder(h)
    flat = torch.where(keep, key.div(h, rounding_mode="floor") * w
                       + b // bm.WORD_BITS, 0)
    bit = torch.where(keep, bm._wrap_int32(
        torch.ones_like(b) << b.remainder(bm.WORD_BITS)), 0)
    words = torch.zeros(rows * w, dtype=torch.int32, device=ids.device)
    words.index_add_(0, flat, bit)
    return words.view(rows, w)


def or_existing(cfg: HippoConfig, state: HippoState, ids: torch.Tensor,
                page_ids: torch.Tensor) -> HippoState:
    """``insert_batch_existing`` for tuples of bucket ids ``ids`` (already
    probed) on summarized pages ``page_ids``."""
    slots, _ = locate_slots(state, page_ids)
    return state._replace(bitmaps=state.bitmaps | _or_bits(
        cfg, state.bitmaps.shape[0], slots, ids))


def insert_batch_existing(cfg: HippoConfig, state: HippoState,
                          values: torch.Tensor, page_ids: torch.Tensor,
                          mask: torch.Tensor) -> HippoState:
    """The batch update for tuples landing on already-summarized pages:
    bucketize every value (one launch), locate every owning slot with one
    binary search of the sorted list, and OR the new bits in. Never
    relocates. ``mask`` selects the tuples to apply."""
    mask = mask.to(torch.bool)
    return or_existing(cfg, state, bucketize(state.histogram, values[mask]),
                       page_ids[mask])


# ---------------------------------------------------------------------------
# Maintenance — lazy delete / vacuum (§5.2)
# ---------------------------------------------------------------------------

def resummarize_slots(cfg: HippoConfig, state: HippoState, keys: torch.Tensor,
                      valid: torch.Tensor, affected: torch.Tensor
                      ) -> HippoState:
    """Re-summarize the page ranges of ``affected`` slots (vacuum, §5.2).

    Pages are assigned to slots as the reference assigns them: each live
    affected slot marks its start page with its slot id, a running maximum
    carries the marks forward, and a page belongs to the carried slot while
    it is at or before that slot's end. Only those pages' tuples are
    bucketized (one launch; an invalid tuple sets bucket H-1, as in the
    reference's page bits) and OR-ed into fresh bitmaps (``_or_bits``); every
    affected slot takes its fresh bitmap (zero if it got no page), the rest
    keep theirs. ``affected``: (S,) bool.
    """
    num_pages, card = keys.shape
    s = state.bitmaps.shape[0]
    dev = state.bitmaps.device
    slot_ids = torch.arange(s, dtype=torch.int64, device=dev)
    live = state.slot_live & (slot_ids < state.num_slots) & affected
    if num_pages:
        marks = torch.full((num_pages,), -1, dtype=torch.int64, device=dev)
        marks.scatter_reduce_(0, state.starts.long().clamp(0, num_pages - 1),
                              torch.where(live, slot_ids, -1), "amax")
        filled = marks.cummax(0).values
        ends_of = torch.where(filled >= 0,
                              state.ends[filled.clamp(0, s - 1)].long(), -1)
        in_range = (filled >= 0) & (
            torch.arange(num_pages, device=dev) <= ends_of)
        pages = in_range.nonzero()[:, 0]
        seg = filled[pages, None].expand(pages.shape[0], card)
        ids = grouping.tuple_bucket_ids(state.histogram, keys[pages],
                                        valid[pages])
        fresh = _or_bits(cfg, s, seg, ids)
    else:
        fresh = torch.zeros_like(state.bitmaps)
    return state._replace(bitmaps=torch.where(affected[:, None], fresh,
                                              state.bitmaps))


def resummarize_shard(cfg: HippoConfig, state: HippoState, keys: torch.Tensor,
                      valid: torch.Tensor, new_bounds: torch.Tensor
                      ) -> HippoState:
    """Remap a shard's partial histograms onto new complete-histogram bounds:
    every live entry's bitmap rebuilt from its pages under ``new_bounds``,
    and the state's ``bounds`` swapped in the same update. Page ranges, the
    sorted list and counts are untouched."""
    s = state.bitmaps.shape[0]
    live = state.slot_live & (torch.arange(s, device=state.bitmaps.device)
                              < state.num_slots)
    return resummarize_slots(cfg, state._replace(bounds=new_bounds), keys,
                             valid, live)


# ---------------------------------------------------------------------------
# Storage accounting (paper's index-size metric)
# ---------------------------------------------------------------------------

def index_nbytes(cfg: HippoConfig, state: HippoState,
                 compressed: bool = False) -> int:
    """Bytes of live index storage: entries (bitmap + 2 page ids) + sorted
    list + histogram, as the reference counts them. ``compressed=True``
    reports the serialized RLE form of the bitmaps."""
    e = int(state.num_entries)
    live = state.slot_live.cpu().numpy()
    words = state.bitmaps.cpu().numpy().view(np.uint32)[live]
    if compressed:
        bitmap_bytes = sum(bm.compressed_nbytes(row) for row in words)
    else:
        bitmap_bytes = words.nbytes
    return bitmap_bytes + e * 8 + e * 4 + state.bounds.shape[0] * 4
