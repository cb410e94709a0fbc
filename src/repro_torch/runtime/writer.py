"""Async maintenance writer — insert/vacuum off the query path (§5, Alg. 3;
port of ``repro.runtime.writer``).

``MaintenanceWriter`` moves Algorithm 3 and the §5.2 vacuum between engine
batches. A write touches exactly one shard's arrays, so shard s can be
rebuilt while every other shard keeps serving. Lifecycle, per shard:

  stage    ``write(v)`` routes v by ``ShardSpec`` page arithmetic on the table
           tail into the owning shard's pending queue: a host list append,
           nothing on the device.
  overlay  queries stay exact while rows wait: the fused dense and compact
           batches (``core.partition``) and the engine's routed dispatch add
           the staged rows matching each predicate to the index's counts.
           Staged rows occupy no page until their drain, so they appear in
           counts only, never in row ids or page masks. ``delete(lo, hi)``
           marks table tuples invalid at once and kills staged rows in range;
           ``delete_rows(ids)`` marks exactly the table tuples at those row
           ids invalid (a staged row has no id until its drain). Each
           brings the table's cached slab view in step at once
           (``PagedTable.sync_slab_view``: the slabs a range delete hit,
           the bits of the deleted ids).
  drain    between engine batches the writer takes one shard's whole queue,
           appends it to the table (``PagedTable.append``: the pages and fills
           of the reference's per-value inserts) and applies Algorithm 3 to a
           copy of that shard's state: one OR for the live rows on summarized
           pages (``insert_batch_existing``), then the page-opening rows in
           order (``insert_tuples``: one bucket-probe launch, host replay),
           each with the reference's capacity check. Dirty shards get their
           ``vacuum_shard`` the same way. Queues drain in ascending shard
           order, so staged page ids land where stage-time routing put them.
  swap     one assignment publishes the rebuilt shard and its summary, and
           the table copies the pages the drain appended, from the old tail
           page on, into its cached slab view (``sync_slab_view``). While
           the swap is in flight the index refuses queries and maintenance
           (``swap_in_flight``).

A drain that refuses (slot capacity) rolls the table back to its pre-drain
snapshot and requeues the shard's rows; the overlay keeps counts exact.

Drift re-summarization: every staged insert feeds a
``histogram.DriftTracker``. ``schedule_resummarize`` queues a third drain-unit
kind, one per shard, each remapping that shard's bitmaps onto new bounds
(``histogram.rebuild`` or ``learned.learned_rebuild`` from the reservoir,
by the index's summary policy; ``core.index.resummarize_shard``) under the
same swap discipline. Remap units drain before insert queues, so staged rows
land under the new bounds; each remapped shard bumps its ``bounds_epochs``
entry.

Durability: with a ``checkpointing.wal.Journal`` attached (``journal``),
every staged insert, every delete (by key range or by row id) and every
scheduled re-summarization appends its record before the writer changes
any state (append before admission), so an acknowledged operation
survives a crash at any instant. ``write_many`` stages rows as one
transaction: one record for all of them (one sync), then each row as
``write`` stages it; ``write`` appends a record a row.
``checkpointing.snapshot.recover_index`` replays the journal through a
fresh writer. ``dirty_checkpoint_shards`` is the delta capture set of the
durable commits.

``runtime.engine.QueryEngine`` owns the interleave, drift and durability
policies; the writer is mechanism.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import histogram as hg
from repro_torch.core import index as hix
from repro_torch.core import learned as ln
from repro_torch.core.partition import SUMMARY_POLICIES
from repro_torch.runtime.faultinject import crashpoint
from repro_torch.spans import span

_STAGE_BUCKET_MIN = 8   # smallest device overlay width


class _ShardQueue:
    """Pending inserts for one shard, kept in table-append order.

    ``live`` marks rows not yet killed by a staged delete; the sorted view of
    live values backs the overlay's interval counting.
    """
    __slots__ = ("values", "live", "n_live", "_sorted")

    def __init__(self):
        self.values: list[float] = []
        self.live: list[bool] = []
        self.n_live = 0
        self._sorted: np.ndarray | None = None

    def append(self, v: float) -> None:
        self.values.append(v)
        self.live.append(True)
        self.n_live += 1
        self._sorted = None

    def kill_range(self, lo: float, hi: float) -> int:
        """Mark live staged values in [lo, hi] dead (a delete overtaking a
        staged insert); they never reach the index's bitmaps."""
        n = 0
        for i, (v, alive) in enumerate(zip(self.values, self.live)):
            if alive and lo <= v <= hi:
                self.live[i] = False
                n += 1
        if n:
            self.n_live -= n
            self._sorted = None
        return n

    @property
    def sorted_live(self) -> np.ndarray:
        if self._sorted is None:
            self._sorted = np.sort(np.asarray(
                [v for v, alive in zip(self.values, self.live) if alive],
                np.float32))
        return self._sorted


@dataclass
class WriterStats:
    staged: int = 0           # tuples ever staged
    killed: int = 0           # staged tuples overtaken by a delete
    drains: int = 0           # drain units applied (inserts + vacuums + resummarizes)
    drained_rows: int = 0     # live tuples applied to the index by drains
    vacuums: int = 0          # shard vacuums drained
    resummarizes: int = 0     # shard remaps drained (drift re-summarization)
    learned_refits: int = 0   # resummarize schedules served by a learned fit
    learned_fallbacks: int = 0  # learned schedules that fell back to equal-mass
    last_drain_us: float = 0.0
    total_drain_us: float = 0.0
    # the port's own, after the reference's fields
    rows_deleted: int = 0     # table tuples deleted by row id (delete_rows)
    patch_bytes: int = 0      # host-to-device bytes of every slab patch


class MaintenanceWriter:
    """Per-shard staged maintenance over a ``ShardedHippoIndex``.

    Constructing the writer attaches it to the index (``index.staging``), so
    every search path folds the staging overlay into counts from then on.
    Drains, the overlay and remaps run on the index's device. ``journal``
    (a ``checkpointing.wal.Journal``, or None) makes every staged operation
    durable before it is admitted.
    """

    def __init__(self, index, journal=None):
        for attr in ("spec", "state", "plan_batch"):
            if not hasattr(index, attr):
                raise ValueError(
                    "MaintenanceWriter needs a ShardedHippoIndex-style index "
                    "(ShardSpec routing + stacked per-shard state); got "
                    f"{type(index).__name__}")
        prior = getattr(index, "staging", None)
        if prior is not None and prior.queue_depth:
            # replacing the attached writer would drop its staged rows from
            # every count
            raise RuntimeError(
                f"index already has a writer with {prior.queue_depth} staged "
                f"rows pending: flush() it before attaching a new one")
        self.index = index
        index.staging = self
        # write-ahead journal: write(), write_many(), delete(), delete_rows()
        # and schedule_resummarize() append their record before mutating
        # anything
        self.journal = journal
        self._queues: dict[int, _ShardQueue] = {}
        self._staged_total = 0       # pending tuples, dead rows included
        self._version = 0            # bumps on any staging change
        self._dev_cache: tuple | None = None
        self.stats = WriterStats()
        # drift telemetry, armed with the bounds serving the table tail
        # (where appends route); rearmed when a re-summarization completes
        s_tail = min(index.spec.owner(max(index.table.num_pages - 1, 0)),
                     index.spec.num_shards - 1)
        self.drift = hg.DriftTracker(index.shard_histogram(s_tail))
        self._pending_resummarize: list[int] = []
        self._pending_bounds: np.ndarray | None = None
        self._pending_model = None   # learned model behind the pending bounds
        self._resum_epoch = 0
        # shards whose published state or table slab changed since the last
        # durable commit (the delta capture set of durable storage)
        self._dirty_since_checkpoint: set[int] = set()

    # -- staging (the off-query-path write surface) --------------------------

    def _check_attached(self) -> None:
        """Refuse staging through a writer the index no longer consults."""
        if self.index.staging is not self:
            raise RuntimeError(
                "writer is detached: the index has a different (newer) "
                "staging writer attached; stage through that one")

    def _tail_pos(self) -> int:
        """Absolute tuple position of the table's append tail."""
        t = self.index.table
        if t.num_pages == 0:
            return 0
        return t.num_pages * t.page_card - (t.page_card - t.fill)

    def _route(self, n: int) -> list[int]:
        """The owning shards of the next ``n`` staged tuples. The k-th
        staged tuple's page is fixed by the table tail (appends are
        sequential). Refuses a tuple the shard layout can never hold."""
        spec = self.index.spec
        pos = self._tail_pos() + self._staged_total
        card = self.index.table.page_card
        shards = [spec.owner((pos + i) // card) for i in range(n)]
        if shards and shards[-1] >= spec.num_shards:
            page = (pos + n - 1) // card
            raise RuntimeError(
                f"shard layout full: staged tuple would land on page {page}, "
                f"past shard {spec.num_shards - 1}'s slab "
                f"(pages_per_shard={spec.pages_per_shard}); rebuild with more "
                f"shards or larger slabs")
        return shards

    def _stage(self, shards: list[int], values: list[float]) -> None:
        for s, v in zip(shards, values):
            self._queues.setdefault(s, _ShardQueue()).append(v)
        self._staged_total += len(values)
        self._version += 1
        self._dev_cache = None
        self.stats.staged += len(values)
        self.drift.observe(np.asarray(values, np.float32))

    def write(self, value: float) -> int:
        """Stage one insert; returns the owning shard. Refuses, before
        staging, a write the shard layout can never hold."""
        self.index._check_swap_guard()
        self._check_attached()
        [s] = self._route(1)
        if self.journal is not None:
            # durable before acknowledged: if this append fails, the write
            # raises with nothing staged and nothing to lose
            self.journal.append_insert(s, float(value))
        self._stage([s], [float(value)])
        return s

    def write_many(self, values) -> list[int]:
        """Stage rows as one transaction; returns each row's owning shard.
        The rows land where as many ``write`` calls would put them, with
        the same queues, drift observations and stats, but the journal
        takes one record for all of them, so a crash keeps all or none.
        Refuses, before staging any, a group the shard layout cannot hold
        whole."""
        self.index._check_swap_guard()
        self._check_attached()
        vals = [float(v) for v in values]
        shards = self._route(len(vals))
        if not vals:
            return []
        if self.journal is not None:
            self.journal.append_insert_group(shards, vals)
        self._stage(shards, vals)
        return shards

    def delete(self, lo: float, hi: float) -> int:
        """Table tuples in [lo, hi] go invalid now (queries read the validity
        mask), staged rows in range die before reaching the table, and the
        dirtied shards queue for a drained ``vacuum_shard``. Returns tuples
        deleted (table + staged)."""
        self.index._check_swap_guard()
        self._check_attached()
        if self.journal is not None:
            self.journal.append_delete(float(lo), float(hi))
        table = self.index.table
        n = table.delete_where(lo, hi)
        if n:
            self._dirty_since_checkpoint.update(
                int(s) for s in self.index.dirty_shards())
            with span("hippo.writer.patch"):
                self.stats.patch_bytes += table.sync_slab_view()
        killed = 0
        for q in self._queues.values():
            killed += q.kill_range(lo, hi)
        if killed:
            self._version += 1
            self._dev_cache = None
            self.stats.killed += killed
        return n + killed

    def delete_rows(self, row_ids) -> int:
        """Table tuples at global row ids (``page * page_card + slot``) go
        invalid now, exactly those; their pages take dirty notes, so their
        shards queue vacuum units as ``delete``'s do. The host work grows
        with the ids, not with the table: the shards come from the ids' own
        pages, and the cached slab view has just those tuples' bits cleared
        in place (``PagedTable.sync_slab_view``). An id past the table's
        tail is refused before any change (a staged row has no id until
        its drain; IndexError). With a journal attached the ids are
        journaled first, as one record. Ids already deleted count 0;
        returns the tuples deleted."""
        self.index._check_swap_guard()
        self._check_attached()
        table = self.index.table
        ids = table.checked_row_ids(row_ids)
        if self.journal is not None and ids.size:
            self.journal.append_row_delete(ids)
        ids = table.delete_checked_rows(ids)
        if ids.size:
            pages = ids // table.page_card
            self._dirty_since_checkpoint.update(int(s) for s in np.unique(
                pages // self.index.spec.pages_per_shard))
            with span("hippo.writer.patch"):
                self.stats.patch_bytes += table.sync_slab_view()
        self.stats.rows_deleted += int(ids.size)
        return int(ids.size)

    # -- introspection -------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        """Staged tuples pending a drain (dead rows included: they still
        occupy a staged table position)."""
        return self._staged_total

    @property
    def staged_rows(self) -> int:
        """Live staged rows currently overlaid into query counts."""
        return sum(q.n_live for q in self._queues.values())

    def pending_shards(self) -> list[int]:
        """Shards with queued inserts, in the mandatory drain order."""
        return sorted(s for s, q in self._queues.items() if q.values)

    def pending_vacuum_shards(self) -> list[int]:
        return [int(s) for s in self.index.dirty_shards()]

    def pending_resummarize_shards(self) -> list[int]:
        """Shards still awaiting their remap onto the pending bounds."""
        return list(self._pending_resummarize)

    @property
    def pending_units(self) -> int:
        """Drain units outstanding (resummarizes + insert queues + vacuums)."""
        return (len(self._pending_resummarize) + len(self.pending_shards())
                + len(self.pending_vacuum_shards()))

    def dirty_checkpoint_shards(self) -> list[int]:
        """Shards changed since the last durable commit (delta capture set)."""
        return sorted(self._dirty_since_checkpoint)

    def clear_checkpoint_dirty(self) -> None:
        """Mark the current state durably captured."""
        self._dirty_since_checkpoint.clear()

    # -- drift re-summarization (the third drain-unit kind) ------------------

    def schedule_resummarize(self, bounds=None, policy=None) -> hg.Histogram:
        """Queue a remap of every shard onto new histogram bounds.

        With ``bounds=None`` the bounds come from the drift reservoir under
        ``policy`` (default: the index's ``summary``): ``equal_mass`` blends
        the armed bounds with the reservoir (``histogram.rebuild``);
        ``learned`` fits the same blend (``learned.learned_rebuild``,
        counted in ``stats.learned_refits``, or ``learned_fallbacks`` when a
        degenerate sample falls back to equal mass). An explicit ``bounds``
        array schedules a manual remap. Rescheduling replaces the pending
        bounds and re-queues every shard. The bounds are validated when a
        unit drains. Returns the histogram the shards will serve, on the
        index's device.
        """
        self.index._check_swap_guard()
        self._check_attached()
        if policy is None:
            policy = getattr(self.index, "summary", "equal_mass")
        if policy not in SUMMARY_POLICIES:
            raise ValueError(f"policy must be one of {SUMMARY_POLICIES}, "
                             f"got {policy!r}")
        pending_model = None
        refit = fallback = False
        if bounds is None:
            sample = self.drift.sample()
            if sample.size == 0:
                raise RuntimeError(
                    "no drift sample: stage inserts through write() before "
                    "scheduling a reservoir-based resummarize, or pass "
                    "explicit bounds")
            if policy == "learned":
                hist, model = ln.learned_rebuild(self.drift.armed_histogram,
                                                 sample)
                pending_model = model
                fallback = model is None
                refit = not fallback
            else:
                hist = hg.rebuild(self.drift.armed_histogram, sample)
            bounds = hg.host_bounds(hist)
        bounds = np.asarray(bounds, np.float32)
        if self.journal is not None:
            # the materialized bounds are journaled (not the reservoir they
            # came from), so replay schedules the identical remap; nothing
            # above changed writer state, so a crash before the record is
            # durable leaves no trace of the unacknowledged operation
            self.journal.append_resummarize(bounds, policy)
        self._pending_model = pending_model
        if fallback:
            self.stats.learned_fallbacks += 1
        elif refit:
            self.stats.learned_refits += 1
        self._pending_bounds = bounds
        self._pending_resummarize = list(range(self.index.spec.num_shards))
        self._resum_epoch = int(self.index.bounds_epochs.max()) + 1
        return hg.Histogram(torch.from_numpy(bounds.copy()).to(
            self.index.device))

    def queue_depths(self) -> dict[int, int]:
        """Per-shard staged tuple counts (engine stats surface)."""
        return {s: len(q.values) for s, q in self._queues.items() if q.values}

    # -- overlay (queries never go stale) ------------------------------------

    def staged_counts(self, los, his) -> np.ndarray:
        """(Q, S) exact counts of live staged rows per (query, shard), from
        host ``los``/``his``: two binary searches per (query, shard) on the
        sorted staging buffers; empty predicates (lo > hi) count zero. Host
        twin of ``core.index.staged_overlay_counts``."""
        los = np.asarray(los, np.float32)
        his = np.asarray(his, np.float32)
        out = np.zeros((los.shape[0], self.index.spec.num_shards), np.int64)
        for s, q in self._queues.items():
            a = q.sorted_live
            if a.size == 0:
                continue
            out[:, s] = (np.searchsorted(a, his, side="right")
                         - np.searchsorted(a, los, side="left"))
        return np.maximum(out, 0)

    def device_buffers(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(vals (S, B) f32, live (S, B) bool) staged rows on the index's
        device for the fused overlay (``core.index.staged_overlay_counts``):
        each shard's live values sorted into a prefix. B is the largest
        per-shard live depth rounded up to a power of two (at least 8), as
        the reference pads it; cached until staging changes."""
        if self._dev_cache is not None and self._dev_cache[0] == self._version:
            return self._dev_cache[1], self._dev_cache[2]
        s_n = self.index.spec.num_shards
        depth = max((q.n_live for q in self._queues.values()), default=0)
        b = _STAGE_BUCKET_MIN
        while b < depth:
            b *= 2
        vals = np.zeros((s_n, b), np.float32)
        live = np.zeros((s_n, b), bool)
        for s, q in self._queues.items():
            a = q.sorted_live
            vals[s, : a.size] = a
            live[s, : a.size] = True
        dev = self.index.device
        out = (torch.from_numpy(vals).to(dev), torch.from_numpy(live).to(dev))
        self._dev_cache = (self._version, *out)
        return out

    # -- drain / swap --------------------------------------------------------

    def drain(self, max_units: int | None = None) -> int:
        """Apply up to ``max_units`` drain units (default: everything):
        resummarize remaps first, then insert queues in ascending shard
        order, then dirty shards' vacuums. Returns live rows applied.

        Stats account per applied unit: a unit that refuses partway through
        leaves the units (and wall time) already applied in
        ``stats.drains``/``last_drain_us``/``total_drain_us``.
        """
        t0 = time.perf_counter()
        units = rows = 0
        try:
            for s in self.pending_resummarize_shards():
                if max_units is not None and units >= max_units:
                    break
                self._drain_resummarize(s)
                units += 1
            for s in self.pending_shards():
                if max_units is not None and units >= max_units:
                    break
                with span("hippo.writer.insert"):
                    rows += self._drain_shard(s)
                units += 1
            for s in self.pending_vacuum_shards():
                if max_units is not None and units >= max_units:
                    break
                with span("hippo.writer.vacuum"):
                    self._drain_vacuum(s)
                units += 1
        finally:
            if units:
                us = (time.perf_counter() - t0) * 1e6
                self.stats.drains += units
                self.stats.last_drain_us = us
                self.stats.total_drain_us += us
        return rows

    def flush(self) -> int:
        """Drain every pending queue and vacuum; returns rows applied."""
        return self.drain(max_units=None)

    def discard(self) -> int:
        """Drop every staged row without applying it; returns rows dropped.

        The recovery path for a drain that keeps refusing. All or nothing:
        later queues' page routing assumed that earlier queues land.
        """
        dropped = self._staged_total
        self._queues.clear()
        self._staged_total = 0
        self._version += 1
        self._dev_cache = None
        return dropped

    def _drain_shard(self, s: int) -> int:
        """Drain shard s's queue: append it to the table, apply Algorithm 3
        to a copy of the shard's state, swap it in, and copy the pages it
        appended to into the table's cached slab view."""
        idx = self.index
        table = idx.table
        spec = idx.spec
        cfg = idx.cfg
        q = self._queues.pop(s)
        values = np.asarray(q.values, np.float32)
        live = np.asarray(q.live, bool)
        snap_pages, snap_fill = table.num_pages, table.fill
        idx.swap_in_flight = s
        try:
            # the shard's tensors as views: every update below makes copies
            st = hix.shard_state(idx.state.shards, s)
            # dead staged rows occupy their predicted slots but never go
            # live: they keep later queues' page routing exact
            pages = table.append(values, live)
            if pages.size and not (pages // spec.pages_per_shard == s).all():
                raise RuntimeError(
                    f"writer invariant violated: shard {s} drain appended "
                    f"pages outside its slab (was the table mutated behind "
                    f"the staged queues?)")
            lp = pages - spec.page_lo(s)
            # Algorithm 3 against the copy: one OR for the live tuples on
            # pages summarized before the drain ...
            old = live & (lp <= int(st.summarized_until))
            dev = idx.device
            if old.any():
                st = hix.insert_batch_existing(
                    cfg, st, torch.from_numpy(values[old]).to(dev),
                    torch.from_numpy(lp[old]).to(dev),
                    torch.ones(int(old.sum()), dtype=torch.bool, device=dev))
            # ... then the rest in order (the page-opening tuples and those
            # after them), each capacity-checked against the copy
            rest = live & ~old

            def full(num_slots: int) -> None:
                raise RuntimeError(
                    f"shard {s} at slot capacity ({num_slots}/"
                    f"{cfg.max_slots}); rebuild with a larger max_slots")

            st, _ = hix.insert_tuples(cfg, st, values[rest], lp[rest],
                                      on_full=full)
            # atomic swap: one assignment publishes the rebuilt shard and
            # its summary; every other shard's tensors are untouched
            crashpoint("drain.pre_swap")
            idx._apply_shard(s, st)
        except Exception:
            table.truncate_to(snap_pages, snap_fill)
            self._queues[s] = q      # rows stay staged; overlay stays exact
            raise
        finally:
            idx.swap_in_flight = None
        self._staged_total -= len(q.values)
        self._version += 1
        self._dev_cache = None
        self._dirty_since_checkpoint.add(s)
        with span("hippo.writer.patch"):
            self.stats.patch_bytes += table.sync_slab_view()
        applied = int(live.sum())
        idx.counters.inserts += applied
        self.stats.drained_rows += applied
        return applied

    def _drain_vacuum(self, s: int) -> int:
        """Drain one shard's §5.2 vacuum under the swap guard."""
        idx = self.index
        idx.swap_in_flight = s
        try:
            n = idx._vacuum_shard_locked(s)
        finally:
            idx.swap_in_flight = None
        if n:
            self._dirty_since_checkpoint.add(s)
        self.stats.vacuums += 1
        return n

    def _drain_resummarize(self, s: int) -> None:
        """Drain one shard's drift remap: rebuild its bitmaps onto the
        pending bounds against a copy of its state, swap it in, bump the
        shard's bounds epoch. A refusal (invalid pending bounds) releases the
        guard with the old state and bounds serving; the unit stays pending.
        The remap changes bitmaps, not pages: no slab to patch."""
        idx = self.index
        b = self._pending_bounds
        idx.swap_in_flight = s
        try:
            if b is None or b.ndim != 1 or b.shape[0] != idx.cfg.resolution + 1:
                raise RuntimeError(
                    f"resummarize refused: pending bounds must be a "
                    f"({idx.cfg.resolution + 1},) boundary array, got "
                    f"{None if b is None else b.shape}")
            if not bool((np.diff(b) > 0).all()):
                raise RuntimeError(
                    "resummarize refused: pending bounds are not strictly "
                    "increasing (tied or decreasing boundaries would make "
                    "bucketize and the remap disagree)")
            keys, valid = idx._slabs()
            st = hix.resummarize_shard(
                idx.cfg, hix.shard_state(idx.state.shards, s), keys[s],
                valid[s], torch.from_numpy(b.copy()).to(idx.device))
            idx._apply_shard(s, st)
        finally:
            idx.swap_in_flight = None
        idx.bounds_epochs[s] = self._resum_epoch
        self._dirty_since_checkpoint.add(s)
        models = getattr(idx, "summary_models", None)
        if models is not None:
            # shard s now serves the pending bounds: its model (None under
            # equal-mass or a fallback) swaps in at the same moment
            models[s] = self._pending_model
        self._pending_resummarize.remove(s)
        self.stats.resummarizes += 1
        if not self._pending_resummarize:
            # every shard serves the new bounds: measure drift against them
            self.drift.rearm(hg.Histogram(torch.from_numpy(b.copy()).to(
                idx.device)))
            self._pending_bounds = None
            self._pending_model = None
