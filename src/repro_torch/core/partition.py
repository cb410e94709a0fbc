"""Sharded partition layer — Hippo over contiguous page slabs (port of
``repro.core.partition``).

The page space is split into S contiguous slabs of ``pages_per_shard``
pages, and every shard carries a full, independent Hippo structure over its
slab (entry page ids local to the slab). On one card the shard axis is a
batch dimension of every tensor.

Ported here: ``ShardSpec``, ``ShardedHippoState``, ``summary_of``,
``set_shard``, ``build_sharded`` and ``ShardedHippoIndex``: the fused
compact and dense batches, one shard's dense batch, ``plan_batch`` (the
summary test of every query against every shard, which the engine's routed
dispatch reads), and maintenance routed to the owning shard: the eager
``insert``, the atomic ``insert_batch``, ``vacuum`` and ``vacuum_shard``,
each recomputing the touched shard's summary.

Persistence (``save``, ``save_delta``, ``load``) goes through
``checkpointing.snapshot``: the same ``HIPPOIX1`` directories the reference
writes and reads.

Summary policies (``SUMMARY_POLICIES``): ``equal_mass`` builds the bounds as
quantiles of the build sample, ``learned`` fits them with
``core.learned.build_histogram`` (the same sample); the writer's drift refits
follow the index's policy.

A ``runtime.writer.MaintenanceWriter`` attaches as ``staging``: the fused
dense and compact batches add its staged rows to their counts, and it sets
``swap_in_flight`` while a drain swaps a shard, which every query and
maintenance surface refuses. Bounds epochs: every shard carries its own
bounds row; a drift remap moves shards onto new bounds one drain unit at a
time, bumping ``bounds_epochs[s]``, and a batch's predicates convert
under each shard's own bounds row into (S, Q, W) query bitmaps (one
bucket-probe launch for every row), so counts stay exact while shards sit
on different epochs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import bitmap as bm
from repro_torch.core import histogram as hg
from repro_torch.core import index as hix
from repro_torch.core import learned as ln
from repro_torch.core.hippo import (MaintenanceCounters, sample_histogram,
                                    sample_keys)
from repro_torch.core.predicate import (Predicate, intervals,
                                        interval_bitmaps_sharded,
                                        to_bucket_bitmaps, upload_intervals)
from repro_torch.device import resolve_device
from repro_torch.kernels.batch_filter import batch_filter_sharded
from repro_torch.spans import span
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
    """(W,) packed union of one shard's live entry bitmaps (pruning filter),
    on the state's device."""
    slots = st.bitmaps.shape[0]
    live = st.slot_live & (torch.arange(slots, device=st.bitmaps.device)
                           < st.num_slots)
    return bm.or_reduce(torch.where(live[:, None], st.bitmaps, 0))


def _with_row(stacked: torch.Tensor, s: int, row: torch.Tensor
              ) -> torch.Tensor:
    out = stacked.clone()
    out[s] = row
    return out


def set_shard(shards: hix.HippoState, s: int, st: hix.HippoState
              ) -> hix.HippoState:
    """The stacked state with shard s replaced by ``st`` (copies: the given
    stack is unchanged)."""
    return hix.HippoState(*(_with_row(stacked, s, new)
                            for stacked, new in zip(shards, st)))


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
    # The attached ``runtime.writer.MaintenanceWriter`` (None: maintenance is
    # synchronous); its staged rows overlay into the fused batches' counts.
    staging: object | None = field(default=None, repr=False, compare=False)
    # Shard id a writer drain is swapping (None otherwise); queries and
    # maintenance refuse while set.
    swap_in_flight: int | None = field(default=None, repr=False, compare=False)
    # Per-shard bounds epoch, bumped when a drift remap moves shard s onto
    # new bounds.
    bounds_epochs: np.ndarray = field(default=None, repr=False, compare=False)
    # Summary policy (SUMMARY_POLICIES), read by the writer at every
    # ``schedule_resummarize``.
    summary: str = "equal_mass"
    # Per-shard learned model (``learned.PiecewiseLinearModel``) whose bounds
    # shard s serves; None under equal-mass bounds or after a fallback.
    summary_models: list = field(default=None, repr=False, compare=False)

    def __post_init__(self):
        if self.bounds_epochs is None:
            self.bounds_epochs = np.zeros((self.spec.num_shards,), np.int64)
        if self.summary not in SUMMARY_POLICIES:
            raise ValueError(f"summary must be one of {SUMMARY_POLICIES}, "
                             f"got {self.summary!r}")
        if self.summary_models is None:
            self.summary_models = [None] * self.spec.num_shards

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
        model = None
        if hist is None:
            if summary == "learned":
                # the equal-mass path's build sample, fitted instead of
                # quantiled; a degenerate sample falls back inside
                hist, model = ln.build_histogram(
                    sample_keys(table, sample_size), resolution, device=dev)
            else:
                hist = sample_histogram(table, resolution, sample_size,
                                        device=dev)
        state = build_sharded(cfg, spec, hist, table, dev)
        return ShardedHippoIndex(cfg=cfg, spec=spec, state=state, table=table,
                                 device=dev, summary=summary,
                                 summary_models=[model] * num_shards)

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

    def _check_no_staged(self) -> None:
        """Refuse direct inserts while a writer holds staged rows: staged
        page routing was predicted from the table tail, and a direct append
        would shift it under the queues."""
        if self.staging is not None and self.staging.queue_depth:
            raise RuntimeError(
                f"writer has {self.staging.queue_depth} staged rows pending: "
                f"route writes through the writer (or flush() it first) — a "
                f"direct insert would shift the table tail and break the "
                f"staged rows' page routing")

    # -- query ---------------------------------------------------------------

    def _query_bitmaps(self, preds: list[Predicate]
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(S, Q, W) packed query bitmaps, row s converted under shard s's
        bounds, and the batch's (Q,) los and his, from one upload and one
        bucket-probe launch over every shard's bounds row: no host
        synchronisation."""
        los, his, nonempty = upload_intervals(preds, self.device)
        qbms = interval_bitmaps_sharded(self.state.shards.bounds, los, his,
                                        nonempty)
        return qbms, los, his

    def search_batch(self, preds: list[Predicate]) -> hix.BatchSearchResult:
        """Fused dense path (``core.index.search_many_sharded``): every shard
        at once, counts reduced across the shard axis; ``page_mask`` in
        global page order, trimmed to the table's pages. Counts equal the
        unsharded ``HippoIndex.search_batch``'s; with a writer attached they
        also include its live staged rows."""
        self._check_swap_guard()
        qbms, los, his = self._query_bitmaps(preds)
        keys, valid = self._slabs()
        if self.staging is not None and self.staging.staged_rows:
            vals, live = self.staging.device_buffers()
            res = hix.search_many_sharded_staged(self.state.shards, qbms, keys,
                                                 valid, los, his, vals, live)
        else:
            res = hix.search_many_sharded(self.state.shards, qbms, keys,
                                          valid, los, his)
        return res._replace(page_mask=res.page_mask[:, : self.table.num_pages])

    def search_compact_batch(self, preds: list[Predicate], *,
                             max_selected: int, top_k: int = 0
                             ) -> hix.CompactBatchResult:
        """Batched gather path over every shard
        (``core.index.search_compact_many_sharded``): each shard selects its
        own ``max_selected``-page slab of the batch union and inspects every
        predicate against it, counts reduced across shards. Row ids are
        global (``page_id * page_card + slot``). With a writer attached the
        counts also include its live staged rows, which occupy no page yet:
        they never enter row ids and cannot truncate."""
        self._check_swap_guard()
        with span("hippo.index.convert"):
            qbms, los, his = self._query_bitmaps(preds)
        keys, valid = self._slabs()
        if self.staging is not None and self.staging.staged_rows:
            vals, live = self.staging.device_buffers()
            return hix.search_compact_many_sharded_staged(
                self.state.shards, qbms, keys, valid, los, his, vals, live,
                max_selected=max_selected, top_k=top_k)
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
        (``core.index.search_many`` on shard s): the engine's routed
        dispatch adds the writer's staged rows itself."""
        self._check_swap_guard()
        keys, valid = self._slabs()
        return hix.search_many(hix.shard_state(self.state.shards, s), qbms,
                               keys[s], valid[s], los, his)

    def plan_batch(self, preds: list[Predicate]
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              np.ndarray]:
        """One predicate conversion for a routed batch.

        Returns (qbms (S, Q, W), los (Q,), his (Q,)) on the index's device
        and the host bool matrix ``match`` (Q, S): the joint-bucket test of
        query q (converted for shard s) against shard s's summary bitmap,
        run through the sharded filter kernel with each summary as a
        one-entry table. False entries are provably count-zero for that
        (query, shard) pair, so a dispatcher may skip them. Only ``match``
        comes to the host.
        """
        self._check_swap_guard()
        qbms, los, his = self._query_bitmaps(preds)             # (S, Q, W)
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

    # -- maintenance ---------------------------------------------------------

    def _require_capacity(self, s: int, page_id: int, opens_page: bool,
                          num_slots: int | None = None) -> None:
        """Refuse, before any mutation, inserts the shard layout cannot hold:
        a page past the last slab, or slot exhaustion inside shard s
        (``num_slots``: shard s's count, read from the state if not given)."""
        if s >= self.spec.num_shards:
            raise RuntimeError(
                f"shard layout full: page {page_id} falls past shard "
                f"{self.spec.num_shards - 1}'s slab "
                f"(pages_per_shard={self.spec.pages_per_shard}); rebuild with "
                f"more shards or larger slabs")
        if opens_page or self.cfg.relocate_on_update:
            if num_slots is None:
                num_slots = int(self.state.shards.num_slots[s])
            if num_slots + 1 > self.cfg.max_slots:
                raise RuntimeError(
                    f"shard {s} at slot capacity ({num_slots}/"
                    f"{self.cfg.max_slots}); rebuild with a larger max_slots")

    def _apply_shard(self, s: int, st: hix.HippoState) -> None:
        self.state = ShardedHippoState(
            shards=set_shard(self.state.shards, s, st),
            summaries=_with_row(self.state.summaries, s, summary_of(st)))

    def insert(self, value: float) -> None:
        """Eager insert routed to the owning shard (Algorithm 3, shard
        local)."""
        self._check_swap_guard()
        self._check_no_staged()
        page_id, opens_page = self.table.next_page_id()
        s = self.spec.owner(page_id)
        self._require_capacity(s, page_id, opens_page)
        self.table.insert(value)
        st = hix.shard_state(self.state.shards, s)
        before = int(st.num_entries)
        st, after = hix.insert_tuples(self.cfg, st, [value],
                                      [self.spec.to_local(page_id)])
        self._apply_shard(s, st)
        self.counters.inserts += 1
        self.counters.entries_touched += 1
        self.counters.entries_created += after - before

    def insert_batch(self, values: np.ndarray) -> None:
        """Atomic vectorized insert: tuples landing on already-summarized
        pages take one fused OR per touched shard; page-opening tuples replay
        the eager path on the host (``core.index.insert_tuples``), one
        bucket-probe launch per touched shard for both. On refusal the table
        and every shard roll back (no update writes into the snapshot)."""
        self._check_swap_guard()
        self._check_no_staged()
        values = np.asarray(values, np.float32).ravel()
        if values.size == 0:
            return
        snap_state = self.state
        snap_pages, snap_fill = self.table.num_pages, self.table.fill
        try:
            self._insert_batch_apply(values)
        except RuntimeError:
            self.state = snap_state
            self.table.truncate_to(snap_pages, snap_fill)
            raise
        self.counters.inserts += len(values)

    def _insert_batch_apply(self, values: np.ndarray) -> None:
        pps = self.spec.pages_per_shard
        owners = self.table.append_pages(values.size) // pps
        over = np.flatnonzero(owners >= self.spec.num_shards)
        if over.size:
            # the reference appends up to the first page past the layout,
            # then refuses (and the caller rolls the table back)
            pid = int(self.table.append(values[: over[0] + 1])[-1])
            raise RuntimeError(
                f"shard layout full: page {pid} falls past shard "
                f"{self.spec.num_shards - 1}'s slab; rebuild with more "
                f"shards or larger slabs")
        pages = self.table.append(values)
        old = pages <= self.summarized_until
        eager = []
        for s in np.unique(owners):
            s = int(s)
            mine = owners == s
            local = pages[mine] - self.spec.page_lo(s)
            ids = hg.bucketize(self.shard_histogram(s), torch.from_numpy(
                values[mine]).to(self.device))
            o = old[mine]
            if o.any():
                st = hix.or_existing(
                    self.cfg, hix.shard_state(self.state.shards, s),
                    ids[torch.from_numpy(o).to(self.device)],
                    torch.from_numpy(local[o]).to(self.device))
                self._apply_shard(s, st)
            if not o.all():
                eager.append((s, local[~o],
                              ids[torch.from_numpy(~o).to(self.device)]))
        for s, local, ids in eager:
            # a tuple opens a page when it lies past the global
            # summarized_until: in shard s's page ids, past the larger of
            # the global value and the shard's own
            st, _ = hix.insert_tuples(
                self.cfg, hix.shard_state(self.state.shards, s), None, local,
                ids=ids, su_floor=self.summarized_until - self.spec.page_lo(s),
                on_full=lambda n, s=s: self._require_capacity(s, 0, True, n))
            self._apply_shard(s, st)

    def dirty_shards(self) -> np.ndarray:
        """Shard ids owning at least one dirty page (pending vacuum work)."""
        dirty_pages = np.flatnonzero(self.table.dirty[: self.table.num_pages])
        return np.unique(dirty_pages // self.spec.pages_per_shard)

    def vacuum(self) -> int:
        """§5.2 lazy maintenance, shard-grouped: dirty pages re-summarize
        entries inside their owning shards only. Returns total entries
        re-summarized."""
        self._check_swap_guard()
        return sum(self._vacuum_shard_locked(int(s))
                   for s in self.dirty_shards())

    def vacuum_shard(self, s: int) -> int:
        """Vacuum one shard: re-summarize its entries covering dirty pages
        and clear only that shard's dirty notes; other shards' state,
        summaries and notes are untouched. Returns entries re-summarized (0
        if the shard has no dirty pages)."""
        self._check_swap_guard()
        return self._vacuum_shard_locked(s)

    def _vacuum_shard_locked(self, s: int) -> int:
        """``vacuum_shard`` without the swap guard (the writer's form). The
        dirty pages are located with one search of the sorted list."""
        dirty_pages = np.flatnonzero(self.table.dirty[: self.table.num_pages])
        pps = self.spec.pages_per_shard
        dirty_pages = dirty_pages[dirty_pages // pps == s]
        if dirty_pages.size == 0:
            return 0
        keys, valid = self._slabs()
        st = hix.shard_state(self.state.shards, s)
        slots, _ = hix.locate_slots(st, torch.from_numpy(
            dirty_pages - self.spec.page_lo(s)))
        affected = torch.zeros((self.cfg.max_slots,), dtype=torch.bool,
                               device=self.device)
        affected[slots.long()] = True
        st = hix.resummarize_slots(self.cfg, st, keys[s], valid[s], affected)
        self._apply_shard(s, st)
        self.table.clear_dirty(dirty_pages)
        n = int(affected.sum())
        # one counted vacuum per shard that did work, on every entry point
        self.counters.vacuums += 1
        self.counters.entries_resummarized += n
        return n

    # -- introspection -------------------------------------------------------

    def shard_histogram(self, s: int) -> hg.Histogram:
        """Shard s's complete histogram (its bounds epoch)."""
        return hg.Histogram(self.state.shards.bounds[s])

    @property
    def histogram(self) -> hg.Histogram:
        """The histogram every shard shares while all sit on one bounds
        epoch (always, outside a partly drained remap); epoch-aware code
        reads ``shard_histogram``."""
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

    # -- persistence (checkpointing.snapshot) --------------------------------

    def save(self, root, *, wal_seqno: int = 0, keep: int = 3, **kw):
        """Durably snapshot this index (table, shards, bounds/epochs, models,
        and any attached writer's staged state) under ``<root>/snap_<N>/``.
        Returns the committed snapshot directory. Extra keywords (``epoch``,
        ``compact``) pass through to
        ``repro_torch.checkpointing.snapshot.save_index``."""
        from repro_torch.checkpointing.snapshot import save_index
        return save_index(root, self, wal_seqno=wal_seqno, keep=keep, **kw)

    def save_delta(self, root, *, shards, wal_seqno: int = 0, **kw):
        """Durably commit an incremental delta — the given shards' index
        sections and table slab rows — against the last full snapshot under
        ``root``. See ``repro_torch.checkpointing.snapshot.save_delta``."""
        from repro_torch.checkpointing.snapshot import save_delta
        return save_delta(root, self, shards=shards, wal_seqno=wal_seqno,
                          **kw)

    @staticmethod
    def load(root, *, epoch: int | None = None,
             device=None) -> "ShardedHippoIndex":
        """Reconstruct the latest (or a given) committed snapshot on
        ``device`` (None: the card). Counts, row ids, bounds, epochs, and
        learned models round-trip exactly; use
        ``checkpointing.snapshot.recover_index`` (or
        ``runtime.engine.QueryEngine.recover``) to also replay a write-ahead
        journal after a crash."""
        from repro_torch.checkpointing.snapshot import load_index
        return load_index(root, epoch=epoch, device=device)[0]
