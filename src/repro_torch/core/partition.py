"""Sharded partition layer — Hippo over contiguous page slabs (port of
``repro.core.partition``, read side).

The page space is split into S contiguous slabs of ``pages_per_shard``
pages, and every shard carries a full, independent Hippo structure over its
slab (entry page ids local to the slab). On one card the shard axis is a
batch dimension of every tensor. Each shard carries its own bounds row, so
predicates convert per bounds epoch into (S, Q, W) query bitmaps; all shards
share one epoch until drift re-summarization is ported.

Ported here: ``ShardSpec``, ``ShardedHippoState``, ``summary_of``,
``build_sharded`` and the read surface of ``ShardedHippoIndex``: the fused
compact and dense batches, one shard's dense batch, and ``plan_batch``, the
summary test of every query against every shard (partition pruning) that
the engine's routed dispatch reads. Inserts, vacuum and the writer
attachment come with later slices (ROADMAP.md, queue 1 items 9-10).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import histogram as hg
from repro_torch.core import index as hix
from repro_torch.core.hippo import MaintenanceCounters, sample_histogram
from repro_torch.core.predicate import (Predicate, _nonempty, intervals,
                                        interval_bitmaps_sharded,
                                        to_bucket_bitmaps)
from repro_torch.device import resolve_device
from repro_torch.kernels.batch_filter import batch_filter_sharded
from repro_torch.storage.table import PagedTable

SUMMARY_POLICIES = ("equal_mass", "learned")


@dataclass(frozen=True)
class ShardSpec:
    """The routing map: shard s owns global pages [s*PPS, (s+1)*PPS)."""
    num_shards: int
    pages_per_shard: int

    @property
    def total_pages(self) -> int:
        return self.num_shards * self.pages_per_shard

    def owner(self, page_id: int) -> int:
        return page_id // self.pages_per_shard

    def page_lo(self, s: int) -> int:
        return s * self.pages_per_shard

    def to_local(self, page_id: int) -> int:
        return page_id - self.page_lo(self.owner(page_id))


class ShardedHippoState(NamedTuple):
    shards: hix.HippoState     # every field stacked along a leading shard axis
    summaries: torch.Tensor    # (S, W) i32 — OR of live entry bitmaps per shard


def summary_of(st: hix.HippoState) -> torch.Tensor:
    """(W,) packed union of one shard's live entry bitmaps (pruning filter)."""
    slots = st.bitmaps.shape[0]
    live = st.slot_live & (torch.arange(slots, device=st.bitmaps.device)
                           < st.num_slots)
    words = st.bitmaps[live].cpu().numpy().view(np.uint32)
    union = np.bitwise_or.reduce(words, axis=0)
    return torch.from_numpy(union.view(np.int32).copy()).to(st.bitmaps.device)


def build_sharded(cfg: hix.HippoConfig, spec: ShardSpec, hist: hg.Histogram,
                  table: PagedTable, device=None) -> ShardedHippoState:
    """Algorithm 2 per shard on ``device``: the grouping scan restarts at
    every slab boundary, so no entry spans two shards."""
    dev = resolve_device(device)
    keys = table.device_keys_sharded(spec.num_shards, spec.pages_per_shard, dev)
    valid = table.device_valid_sharded(spec.num_shards, spec.pages_per_shard,
                                       dev)
    hist = hg.Histogram(hist.bounds.to(dev))
    states = []
    for s in range(spec.num_shards):
        lo = spec.page_lo(s)
        n = max(min(lo + spec.pages_per_shard, table.num_pages) - lo, 0)
        states.append(hix.build(cfg, hist, keys[s, :n], valid[s, :n]))
    summaries = torch.stack([summary_of(st) for st in states])
    return ShardedHippoState(shards=hix.stack_states(states),
                             summaries=summaries)


@dataclass
class ShardedHippoIndex:
    """Shard-parallel Hippo index: the port's serving surface for
    ``runtime.engine.QueryEngine`` (compact mode, fused dense mode and the
    routed dense dispatch through ``plan_batch``/
    ``search_batch_shard_arrays``). ``cfg.max_slots`` is per shard; every
    tensor lives on ``device``."""
    cfg: hix.HippoConfig
    spec: ShardSpec
    state: ShardedHippoState
    table: PagedTable
    device: torch.device
    counters: MaintenanceCounters = field(default_factory=MaintenanceCounters)
    # Shard id a writer drain is swapping (None otherwise); queries refuse
    # while set. No writer exists in this slice, so it stays None.
    swap_in_flight: int | None = field(default=None, repr=False, compare=False)
    summary: str = "equal_mass"

    # -- creation ------------------------------------------------------------

    @staticmethod
    def create(table: PagedTable, num_shards: int = 4, resolution: int = 400,
               density: float = 0.2, pages_per_shard: int | None = None,
               max_slots: int | None = None, sample_size: int = 65536,
               relocate_on_update: bool = True,
               hist: hg.Histogram | None = None,
               summary: str = "equal_mass", device=None
               ) -> "ShardedHippoIndex":
        """CREATE INDEX ... PARTITION BY page range, on ``device`` (None: the
        card). Defaults, validation and layout follow the reference."""
        dev = resolve_device(device)
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if summary not in SUMMARY_POLICIES:
            raise ValueError(f"summary must be one of {SUMMARY_POLICIES}, "
                             f"got {summary!r}")
        if summary == "learned":
            raise NotImplementedError(
                "summary='learned' is not ported yet (ROADMAP.md, queue 1 "
                "item 12: core/learned.py)")
        if pages_per_shard is None:
            target = int(table.num_pages * 1.25) + 64
            pages_per_shard = -(-target // num_shards)
        spec = ShardSpec(num_shards=num_shards, pages_per_shard=pages_per_shard)
        if spec.total_pages < table.num_pages:
            raise ValueError(
                f"shard layout {num_shards}x{pages_per_shard} covers "
                f"{spec.total_pages} pages < table's {table.num_pages}")
        if max_slots is None:
            max_slots = int(pages_per_shard * 1.25) + 1024
        cfg = hix.HippoConfig(resolution=resolution, density=density,
                              page_card=table.page_card, max_slots=max_slots,
                              relocate_on_update=relocate_on_update)
        if hist is None:
            hist = sample_histogram(table, resolution, sample_size, device=dev)
        state = build_sharded(cfg, spec, hist, table, dev)
        return ShardedHippoIndex(cfg=cfg, spec=spec, state=state, table=table,
                                 device=dev, summary=summary)

    # -- device views --------------------------------------------------------

    def _slabs(self) -> tuple[torch.Tensor, torch.Tensor]:
        return (self.table.device_keys_sharded(self.spec.num_shards,
                                               self.spec.pages_per_shard,
                                               self.device),
                self.table.device_valid_sharded(self.spec.num_shards,
                                                self.spec.pages_per_shard,
                                                self.device))

    # -- mid-swap refusal ----------------------------------------------------

    def _check_swap_guard(self) -> None:
        """Refuse queries while a writer drain is swapping a shard: the
        stacked state and the table disagree about it mid-swap."""
        if self.swap_in_flight is not None:
            raise RuntimeError(
                f"shard {self.swap_in_flight} swap in flight: queries and "
                f"maintenance are refused until the writer drain completes "
                f"(state and table disagree about that shard mid-swap)")

    # -- query ---------------------------------------------------------------

    def _query_bitmaps(self, preds: list[Predicate]) -> torch.Tensor:
        """(S, Q, W) packed query bitmaps, row s converted under shard s's
        bounds (one bucket-probe launch per distinct bounds row)."""
        if not preds:
            return bm.zeros(self.cfg.resolution, self.spec.num_shards, 0,
                            device=self.device)
        los, his = intervals(preds, self.device)
        nonempty = torch.from_numpy(_nonempty(preds)).to(self.device)
        return interval_bitmaps_sharded(self.state.shards.bounds, los, his,
                                        nonempty)

    def search_batch(self, preds: list[Predicate]) -> hix.BatchSearchResult:
        """Fused dense path (``core.index.search_many_sharded``): every shard
        at once, counts reduced across the shard axis; ``page_mask`` in
        global page order, trimmed to the table's pages. Counts equal the
        unsharded ``HippoIndex.search_batch``'s."""
        self._check_swap_guard()
        qbms = self._query_bitmaps(preds)
        los, his = intervals(preds, self.device)
        keys, valid = self._slabs()
        res = hix.search_many_sharded(self.state.shards, qbms, keys, valid,
                                      los, his)
        return res._replace(page_mask=res.page_mask[:, : self.table.num_pages])

    def search_compact_batch(self, preds: list[Predicate], *,
                             max_selected: int, top_k: int = 0
                             ) -> hix.CompactBatchResult:
        """Batched gather path over every shard
        (``core.index.search_compact_many_sharded``): each shard selects its
        own ``max_selected``-page slab of the batch union and inspects every
        predicate against it, counts reduced across shards. Row ids are
        global (``page_id * page_card + slot``)."""
        self._check_swap_guard()
        qbms = self._query_bitmaps(preds)
        los, his = intervals(preds, self.device)
        keys, valid = self._slabs()
        return hix.search_compact_many_sharded(
            self.state.shards, qbms, keys, valid, los, his,
            max_selected=max_selected, top_k=top_k)

    @property
    def gather_cap(self) -> int:
        """Per-shard slab width at which the gather path can never truncate."""
        return self.spec.pages_per_shard

    def search_batch_shard(self, s: int, preds: list[Predicate]
                           ) -> hix.BatchSearchResult:
        """Algorithm 1 over shard s's slab only, the predicates converted
        under shard s's bounds."""
        qbms = to_bucket_bitmaps(preds, self.shard_histogram(s))
        los, his = intervals(preds, self.device)
        return self.search_batch_shard_arrays(s, qbms, los, his)

    def search_batch_shard_arrays(self, s: int, qbms, los, his
                                  ) -> hix.BatchSearchResult:
        """Array form of ``search_batch_shard`` for callers that converted
        the predicates once (``plan_batch``): qbms (Q, W) int32 packed words,
        los/his (Q,) f32, on the index's device. Counts are index-only
        (``core.index.search_many`` on shard s)."""
        self._check_swap_guard()
        keys, valid = self._slabs()
        return hix.search_many(hix.shard_state(self.state.shards, s), qbms,
                               keys[s], valid[s], los, his)

    def plan_batch(self, preds: list[Predicate]
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              np.ndarray]:
        """One predicate conversion (per bounds epoch) for a routed batch.

        Returns (qbms (S, Q, W), los (Q,), his (Q,)) on the index's device
        and the host bool matrix ``match`` (Q, S): the joint-bucket test of
        query q (converted for shard s) against shard s's summary bitmap,
        run through the sharded filter kernel with each summary as a
        one-entry table. False entries are provably count-zero for that
        (query, shard) pair, so a dispatcher may skip them. Only ``match``
        comes to the host.
        """
        self._check_swap_guard()
        qbms = self._query_bitmaps(preds)                       # (S, Q, W)
        los, his = intervals(preds, self.device)
        summaries = self.state.summaries[:, None, :].contiguous()  # (S, 1, W)
        live = torch.ones(summaries.shape[:2], dtype=torch.bool,
                          device=self.device)
        match = batch_filter_sharded(qbms, summaries, live)[:, :, 0]  # (S, Q)
        return qbms, los, his, match.T.cpu().numpy()

    def shard_match_matrix(self, preds: list[Predicate]) -> np.ndarray:
        """(Q, S) bool pruning matrix (see ``plan_batch``)."""
        return self.plan_batch(preds)[3]

    def search(self, pred: Predicate) -> hix.BatchSearchResult:
        """Single-predicate convenience: a fused dense batch of one."""
        return self.search_batch([pred])

    def count(self, pred: Predicate) -> int:
        return int(self.search_batch([pred]).counts[0])

    # -- introspection -------------------------------------------------------

    def shard_histogram(self, s: int) -> hg.Histogram:
        """Shard s's complete histogram (its bounds epoch)."""
        return hg.Histogram(self.state.shards.bounds[s])

    @property
    def histogram(self) -> hg.Histogram:
        """The histogram every shard shares while all sit on one bounds
        epoch (always, until drift re-summarization is ported)."""
        return self.shard_histogram(0)

    @property
    def num_shards(self) -> int:
        return self.spec.num_shards

    @property
    def num_entries(self) -> int:
        return int(self.state.shards.num_entries.sum())

    @property
    def summarized_until(self) -> int:
        """Last globally-summarized page id (-1 if the index is empty)."""
        su = self.state.shards.summarized_until.cpu().numpy()
        glob = np.where(su >= 0,
                        su + np.arange(self.spec.num_shards) *
                        self.spec.pages_per_shard, -1)
        return int(glob.max())

    def shard_entry_counts(self) -> np.ndarray:
        return self.state.shards.num_entries.cpu().numpy()

    def nbytes(self, compressed: bool = False) -> int:
        """Live index bytes summed over shards, plus the routing map and the
        per-shard summary bitmaps (as the reference counts them)."""
        total = sum(hix.index_nbytes(self.cfg,
                                     hix.shard_state(self.state.shards, s),
                                     compressed=compressed)
                    for s in range(self.spec.num_shards))
        total += self.spec.num_shards * 8
        return total + self.state.summaries.numel() * 4
