"""Batched multi-predicate query engine — the serving front (port of
``repro.runtime.engine``, read side).

Queries arrive as ``Predicate``s, are admitted into a fixed number of slots,
execute together, and finished queries free their slot for the next queued
request. Free slots in a partly filled batch are padded with the empty
predicate (lo > hi), which matches nothing and is counted in
``EngineStats.pad_slots``, never as served work.

The reference's mode ladder, with every ticket and every counter equal to
the reference's for the same stream:

  compact (the default via ``auto``) — each batch runs through the gather
             path (``search_compact_batch``) of a ``HippoIndex`` or a
             ``ShardedHippoIndex``:
    compact    run at the current slab bucket (a power of two adapted from
               the batches seen so far)
    widen      a batch whose union overflows the bucket raises it to the
               next power of two (capped at the never-truncating
               ``gather_cap``)
    fallback   queries whose own pages overflowed this batch's slab re-run
               at ``gather_cap``, so results are never silently short
  dense — the full-table path. Fused: one ``search_batch`` of the whole
             batch width (a ``HippoIndex``, or a ``ShardedHippoIndex`` with
             ``sharded=False``). Routed (``sharded`` left None on an index
             with ``plan_batch``, or ``sharded=True``; ``auto`` with
             ``sharded=True`` picks it): the batch is tested against every
             shard's summary bitmap, each shard receives one dispatch of only
             the queries that can match it, padded to a power-of-two width
             of at least ``_SHARD_BUCKET_MIN``, shards no query matches are
             skipped (``EngineStats.shards_pruned``), and counts sum over the
             dispatched shards.

Writes (``runtime.writer.MaintenanceWriter``): ``write()``/``delete()``
stage maintenance instead of running Algorithm 3 on the query path; staged
rows are overlaid into counts so results never go stale, and the engine
drains shard queues under one of the reference's interleave policies:

  sync             no writer — ``write`` runs Algorithm 3 on the spot
                   (``index.insert``) and ``delete`` vacuums at once (the
                   default on an unsharded index)
  between_batches  before each ``run_batch`` admits, drain up to
                   ``drain_units`` units (the default on a sharded index)
  on_depth         drain everything once the backlog (staged tuples plus
                   pages dirtied by deletes) reaches ``drain_depth``, checked
                   on writes and deletes
  manual           drain only on ``flush()``

Drift re-summarization: once ``drift_min_observed`` inserts were staged
since the last remap and their edge-bucket overflow ratio reaches
``drift_threshold``, the engine schedules a remap of every shard (one drain
unit per shard, drained by the policy); ``resummarize()`` does it on demand.
``EngineStats`` carries the queue, drain and drift figures and the pruning
window around the last remap, as the reference's does.

Durable storage (``storage_dir``, writer-backed engines): every
acknowledged ``write``/``delete``/``resummarize`` appends its journal record
before it is staged, the engine commits a full snapshot at start and, at
each drain, a delta of the shards the drain changed (a full snapshot under
``snapshot_mode="full"`` or when the compaction policy fires: after
``compact_every`` deltas, or once the chain outweighs ``compact_ratio`` of
its base), then truncates the journal through the commit's watermark.
``background_save`` hands the file I/O to a ``runtime.persister`` thread.
``QueryEngine.recover(storage_dir, device=...)`` rebuilds an engine after
a crash at any instant: the last committed snapshot, its delta chain and
the journal's suffix. The files are the reference's, byte for byte.
"""
from __future__ import annotations

import threading
from collections import deque
from pathlib import Path
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.partition import SUMMARY_POLICIES
from repro_torch.core.predicate import Predicate
from repro_torch.runtime.writer import MaintenanceWriter
from repro_torch.spans import span

_EMPTY = Predicate(lo=1.0, hi=0.0)   # lo > hi: matches nothing


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


_SHARD_BUCKET_MIN = 8     # smallest per-shard dispatch width (routed mode)
_COMPACT_BUCKET_MIN = 64  # smallest gather-slab width
_FALLBACK_Q_MIN = 8       # smallest fallback query width

_DRAIN_POLICIES = ("sync", "between_batches", "on_depth", "manual")
_MODES = ("auto", "compact", "dense")


@dataclass
class QueryTicket:
    """One submitted predicate and, once its batch ran, its results.

    ``row_ids`` is filled only with ``top_k`` set: the first ``top_k``
    qualifying global row ids in ascending order (pads stripped).
    """
    qid: int
    pred: Predicate
    count: int | None = None
    pages_inspected: int | None = None
    entries_matched: int | None = None
    row_ids: np.ndarray | None = None
    done: bool = False


@dataclass
class EngineStats:
    """The reference's ``EngineStats`` fields. In routed dense mode the slot
    counters count per-shard dispatch widths (a query sent to several shards
    fills one slot in each)."""
    submitted: int = 0
    served: int = 0
    batches: int = 0
    slots_filled: int = 0
    pad_slots: int = 0
    shard_dispatches: int = 0
    shards_pruned: int = 0
    shard_queries: dict = field(default_factory=dict)
    shard_slots: dict = field(default_factory=dict)
    # -- compact mode (gather path) ------------------------------------------
    compact_batches: int = 0
    compact_hits: int = 0
    compact_fallbacks: int = 0
    gather_union_pages: int = 0
    gather_slab_pages: int = 0
    selected_pages: int = 0
    table_pages_seen: int = 0
    # -- async maintenance (runtime.writer) ----------------------------------
    writes: int = 0
    deletes: int = 0
    drains: int = 0
    drained_rows: int = 0
    drain_us: float = 0.0
    queue_depth: int = 0
    peak_queue_depth: int = 0
    staged_rows: int = 0
    # -- durable persistence (checkpointing + runtime.persister) -------------
    persists: int = 0          # durable commits (full snapshots + deltas)
    persist_pending: int = 0   # background commits queued or in flight
    persist_lag: int = 0       # journal records not yet covered by a commit
    # -- drift re-summarization ----------------------------------------------
    resummarizes: int = 0
    edge_overflow_ratio: float = 0.0
    learned_refits: int = 0
    learned_fallbacks: int = 0
    pruning_before_resummarize: float = 0.0
    window_selected_pages: int = 0
    window_table_pages: int = 0

    @property
    def occupancy(self) -> float:
        """Fraction of dispatched slots that carried a real query."""
        total = self.slots_filled + self.pad_slots
        return self.slots_filled / total if total else 0.0

    def shard_occupancy(self) -> dict[int, float]:
        """Per-shard occupancy of the routed dispatch."""
        return {s: self.shard_queries[s] / self.shard_slots[s]
                for s in sorted(self.shard_slots) if self.shard_slots[s]}

    @property
    def gather_occupancy(self) -> float:
        """Fraction of dispatched gather-slab capacity holding a selected
        page."""
        return (self.gather_union_pages / self.gather_slab_pages
                if self.gather_slab_pages else 0.0)

    @property
    def selected_page_ratio(self) -> float:
        """Batch-union pages over table pages across compact batches."""
        return (self.selected_pages / self.table_pages_seen
                if self.table_pages_seen else 0.0)

    @property
    def pruning_after_resummarize(self) -> float:
        return (self.window_selected_pages / self.window_table_pages
                if self.window_table_pages else 0.0)


class QueryEngine:
    """Lock-step batched query executor with slot recycling.

    Takes the reference's constructor and validates it the same way.
    ``mode`` and ``sharded`` pick the path (see the module docstring);
    ``top_k`` (compact mode only) makes every ticket carry up to ``top_k``
    qualifying global row ids, and ``compact_bucket`` seeds the adaptive slab
    bucket. The index's device is the engine's: an index created with
    ``device=None`` serves on the card.

    ``drain_policy``, ``drain_units``, ``drain_depth`` and ``writer`` select
    the maintenance interleave (see the module docstring); the drift knobs
    (``drift_threshold``, ``auto_resummarize``, ``drift_min_observed``) and
    ``summary`` (the boundary policy of the remaps this engine schedules;
    None: the index's own) apply to writer-backed engines.

    ``storage_dir`` makes a writer-backed engine durable (see the module
    docstring); the directory must be fresh (``recover`` adopts an existing
    one). ``snapshot_on_drain`` commits at each drain, ``wal_sync`` fsyncs
    each journal record, ``snapshot_mode`` (``"incremental"`` or
    ``"full"``), ``compact_every``, ``compact_ratio`` and ``snapshot_keep``
    (full snapshots kept, each with its chain) shape the commits, and
    ``background_save`` with ``persist_queue`` moves their file I/O to a
    persister thread.
    """

    def __init__(self, index, batch: int = 64, sharded: bool | None = None,
                 drain_policy: str | None = None, drain_units: int = 1,
                 drain_depth: int = 256, writer=None, mode: str = "auto",
                 top_k: int = 0, compact_bucket: int | None = None,
                 drift_threshold: float | None = 0.25,
                 auto_resummarize: bool = True,
                 drift_min_observed: int = 256, summary: str | None = None,
                 storage_dir=None, snapshot_on_drain: bool = True,
                 wal_sync: bool = True, snapshot_mode: str = "incremental",
                 background_save: bool = False, compact_every: int = 8,
                 compact_ratio: float = 0.5, snapshot_keep: int = 3,
                 persist_queue: int = 4):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.index = index
        self.batch = batch
        if mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
        if mode == "auto":
            mode = "dense" if sharded is True else "compact"
        if mode == "compact":
            if sharded is True:
                raise ValueError(
                    "sharded=True selects dense mode's routed dispatch; "
                    "compact mode runs the fused sharded gather — pass "
                    "mode='dense' for routing or drop sharded=True")
            if not hasattr(index, "search_compact_batch"):
                raise ValueError(
                    "mode='compact' needs an index with the gather surface "
                    "(search_compact_batch/gather_cap); got "
                    f"{type(index).__name__}")
            sharded = False
        else:
            if sharded is None:
                sharded = hasattr(index, "plan_batch")
            if sharded and not hasattr(index, "plan_batch"):
                raise ValueError("sharded=True needs a ShardedHippoIndex-style "
                                 "index (plan_batch/search_batch_shard_arrays)")
        self.mode = mode
        self.sharded = sharded
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if top_k and mode != "compact":
            raise ValueError("row-id payloads (top_k > 0) ride the gather "
                             "path; they need mode='compact'")
        self.top_k = top_k
        if compact_bucket is not None and compact_bucket < 1:
            raise ValueError(f"compact_bucket must be >= 1, got {compact_bucket}")
        self._compact_bucket = _pow2_at_least(compact_bucket
                                              or _COMPACT_BUCKET_MIN)
        supports_writer = hasattr(index, "plan_batch")
        if drain_policy is None:
            drain_policy = "between_batches" if supports_writer else "sync"
        if drain_policy not in _DRAIN_POLICIES:
            raise ValueError(f"drain_policy must be one of {_DRAIN_POLICIES}, "
                             f"got {drain_policy!r}")
        if drain_policy != "sync" and not supports_writer:
            raise ValueError(
                "async drain policies need a ShardedHippoIndex-style index "
                "(per-shard queues route by ShardSpec); use "
                "drain_policy='sync' for an unsharded index")
        self.drain_policy = drain_policy
        self.drain_units = drain_units
        self.drain_depth = drain_depth
        if writer is not None and writer.index is not index:
            raise ValueError("writer is bound to a different index than the "
                             "engine's — its staged rows and drains would "
                             "target the wrong index")
        if drift_threshold is not None and not 0.0 < drift_threshold <= 1.0:
            raise ValueError(f"drift_threshold must be in (0, 1] or None, "
                             f"got {drift_threshold}")
        if summary is not None and summary not in SUMMARY_POLICIES:
            raise ValueError(f"summary must be one of {SUMMARY_POLICIES} or "
                             f"None (the index's policy), got {summary!r}")
        if writer is None and drain_policy != "sync":
            writer = MaintenanceWriter(index)
        self.writer = writer
        self.drift_threshold = drift_threshold
        self.auto_resummarize = auto_resummarize
        self.drift_min_observed = drift_min_observed
        self.summary = summary
        self.slots: list[QueryTicket | None] = [None] * batch
        self.queue: deque[QueryTicket] = deque()
        self.stats = EngineStats()
        self._next_qid = 0
        self._auto_drain_suspended = False
        # -- durable storage (checkpointing.snapshot + checkpointing.wal) ----
        # With ``storage_dir`` set, every acknowledged write()/delete()/
        # resummarize journals before it stages, and each drain commits a
        # snapshot then truncates the journal through its watermark. The
        # directory must be fresh: existing durable state is recover()'s.
        self.storage_dir = Path(storage_dir) if storage_dir is not None \
            else None
        self.snapshot_on_drain = snapshot_on_drain
        self.journal = None
        if snapshot_mode not in ("full", "incremental"):
            raise ValueError(f"snapshot_mode must be 'full' or "
                             f"'incremental', got {snapshot_mode!r}")
        if compact_every < 1:
            raise ValueError(f"compact_every must be >= 1, got "
                             f"{compact_every}")
        if compact_ratio <= 0:
            raise ValueError(f"compact_ratio must be > 0, got "
                             f"{compact_ratio}")
        self.snapshot_mode = snapshot_mode
        self.background_save = background_save
        self.compact_every = compact_every
        self.compact_ratio = compact_ratio
        self.snapshot_keep = snapshot_keep
        self.persist_queue = persist_queue
        self._persister = None
        self._base_epoch = None        # epoch of the current full base
        self._delta_seq = 0            # committed deltas against it
        self._full_bytes = 0           # base snapshot payload size
        self._delta_bytes = 0          # cumulative chain payload size
        # the persister's commit callback (_commit_job, worker thread)
        # advances the durable watermark while the foreground reads it for
        # persist_lag; both sides go through this lock
        self._durable_lock = threading.Lock()
        self._durable_watermark = 0    # guarded-by: _durable_lock
        #                                (highest seqno covered by a commit)
        if self.storage_dir is not None:
            if self.writer is None:
                raise ValueError(
                    "storage_dir needs a writer-backed engine (an async "
                    "drain_policy on a ShardedHippoIndex); a writer-less "
                    "index persists directly via index.save()")
            from repro_torch.checkpointing.snapshot import latest_epoch
            from repro_torch.checkpointing.wal import Journal
            journal = Journal(self.storage_dir, index.spec.num_shards,
                              sync=wal_sync)
            if latest_epoch(self.storage_dir) is not None \
                    or journal.last_seqno > 0:
                raise ValueError(
                    f"storage_dir {self.storage_dir} already holds a "
                    f"snapshot or journal — use QueryEngine.recover() to "
                    f"adopt existing durable state")
            self.journal = journal
            if self.writer.journal is None:
                self.writer.journal = journal
            # initial durable base: recovery needs a committed snapshot to
            # replay the journal against, even before the first drain
            self.save()
            self._start_persister()

    # -- admission -----------------------------------------------------------

    def submit(self, pred: Predicate) -> QueryTicket:
        """Enqueue a predicate; returns its ticket (filled in by run_batch)."""
        t = QueryTicket(qid=self._next_qid, pred=pred)
        self._next_qid += 1
        self.stats.submitted += 1
        self.queue.append(t)
        return t

    def _admit(self) -> None:
        if not self.queue:
            return
        with span("hippo.engine.admit"):
            for i in (i for i, t in enumerate(self.slots) if t is None):
                if not self.queue:
                    break
                self.slots[i] = self.queue.popleft()

    # -- writes --------------------------------------------------------------

    def write(self, value: float) -> None:
        """Insert one tuple. Under sync, Algorithm 3 on the spot; otherwise
        the row is staged in its shard's queue and drained by the policy.
        Counts include the row either way."""
        self.stats.writes += 1
        if self.writer is None:
            self.index.insert(float(value))
            return
        self.writer.write(float(value))
        self._maybe_schedule_resummarize()
        if (self.drain_policy == "on_depth"
                and self._maintenance_backlog() >= self.drain_depth):
            self._drain(None)
        self._sync_writer_stats()

    def delete(self, lo: float, hi: float) -> int:
        """Delete tuples with key in [lo, hi]; the validity update is
        immediate (queries stay exact, §5.2). Under sync the vacuum runs at
        once (skipped if nothing was deleted); otherwise the dirty shards
        queue vacuum units. Returns tuples deleted (staged rows included)."""
        if self.writer is None:
            n = self.index.table.delete_where(lo, hi)
            if n:   # a no-op delete dirtied nothing: skip the vacuum
                self.index.vacuum()
            self.stats.deletes += n
            return n
        n = self.writer.delete(lo, hi)
        self.stats.deletes += n
        # deletes add vacuum work, not queue depth: the on_depth trigger
        # must fire here too
        if (self.drain_policy == "on_depth"
                and self._maintenance_backlog() >= self.drain_depth):
            self._drain(None)
        self._sync_writer_stats()
        return n

    def flush(self) -> int:
        """Drain every pending remap, shard queue and vacuum now. Returns
        staged rows applied to the index (0 under sync)."""
        if self.writer is None:
            return 0
        return self._drain(None)

    def resummarize(self, bounds=None) -> int:
        """Schedule a remap of every shard (bounds rebuilt from the drift
        reservoir unless given) and drain it now, with any other pending
        maintenance. Returns remap units applied."""
        if self.writer is None:
            raise RuntimeError(
                "resummarize needs a writer-backed engine (an async "
                "drain_policy on a ShardedHippoIndex)")
        before = self.writer.stats.resummarizes
        # may refuse (no sample): then the stats stay intact
        self.writer.schedule_resummarize(bounds, policy=self.summary)
        self._mark_resummarize_window()
        self._drain(None)
        return self.writer.stats.resummarizes - before

    def _maintenance_backlog(self) -> int:
        """What ``on_depth`` measures: staged tuples plus table pages dirtied
        by deletes and awaiting their vacuum."""
        return self.writer.queue_depth + self.index.table.num_dirty

    def _maybe_schedule_resummarize(self) -> None:
        """The drift trigger: schedule a remap of every shard once enough
        inserts were observed and their edge-bucket overflow ratio crosses
        the threshold; idempotent while a remap is pending."""
        w = self.writer
        if (not self.auto_resummarize or self.drift_threshold is None
                or w is None or w.pending_resummarize_shards()):
            return
        d = w.drift
        if (d.observed >= self.drift_min_observed
                and d.edge_overflow_ratio >= self.drift_threshold):
            w.schedule_resummarize(policy=self.summary)
            self._mark_resummarize_window()

    def _mark_resummarize_window(self) -> None:
        """Close the pruning-quality window: the ratio so far becomes the
        "before" figure, and the window restarts."""
        st = self.stats
        st.pruning_before_resummarize = st.pruning_after_resummarize
        st.window_selected_pages = 0
        st.window_table_pages = 0

    def _drain(self, max_units: int | None) -> int:
        before = self.writer.stats.drains
        try:
            rows = self.writer.drain(max_units)
        finally:
            # a refused drain may have applied some units: report them
            self._sync_writer_stats()
        self._auto_drain_suspended = False      # a successful drain re-arms
        if (self.storage_dir is not None and self.snapshot_on_drain
                and self.writer.stats.drains > before):
            # the drain's commit point: the watermark is recorded before
            # the commit and the journal truncated through it only after,
            # so a crash anywhere between replays nothing twice and loses
            # nothing acknowledged
            self._commit_snapshot()
            self._sync_writer_stats()
        return rows

    # -- durable commits (incremental deltas, background persistence) --------

    def _commit_snapshot(self) -> None:
        """The per-drain durable commit: a delta of the shards this drain
        round changed, or a full snapshot when one is due (first commit,
        ``snapshot_mode='full'``, ``compact_every`` deltas, or a chain of at
        least ``compact_ratio`` of the base). Synchronous unless
        ``background_save`` handed commits to the persister."""
        wm = self.journal.last_seqno
        dirty = self.writer.dirty_checkpoint_shards()
        full_due = (self.snapshot_mode == "full"
                    or self._base_epoch is None
                    or self._delta_seq >= self.compact_every
                    or (self._full_bytes > 0 and self._delta_bytes
                        >= self.compact_ratio * self._full_bytes))
        if self._persister is not None:
            self._submit_background(full_due, dirty, wm)
            return
        if full_due:
            self.save()
            return
        path = self.index.save_delta(
            self.storage_dir, shards=dirty, wal_seqno=wm,
            base_epoch=self._base_epoch, delta_seq=self._delta_seq + 1)
        self._note_delta(path, self._delta_seq + 1)
        self.writer.clear_checkpoint_dirty()
        self._truncate_journal(wm)
        self.stats.persists += 1

    def _submit_background(self, full: bool, dirty, wm: int) -> None:
        """Collect sections in the foreground (the index is mutable again
        when this returns) and hand the file I/O to the persister. The
        epoch or sequence number is reserved here, so jobs commit in
        submission order; the dirty set clears at submit, which is safe
        because a failed job poisons the persister and the only way out is
        a synchronous full save."""
        from repro_torch.checkpointing.snapshot import (collect_delta_sections,
                                                        collect_full_sections)
        from repro_torch.runtime.persister import PersisterPoisoned
        try:
            if full:
                epoch = (self._base_epoch or 0) + 1
                sections = collect_full_sections(self.index, wm)
                self._persister.submit(
                    {"kind": "full", "sections": sections, "epoch": epoch,
                     "compact": self._delta_seq > 0, "watermark": wm})
                self._base_epoch = epoch
                self._delta_seq = 0
                self._full_bytes = sum(a.nbytes for a in sections.values())
                self._delta_bytes = 0
            else:
                seq = self._delta_seq + 1
                sections = collect_delta_sections(self.index, wm, dirty,
                                                  self._base_epoch, seq)
                self._persister.submit(
                    {"kind": "delta", "sections": sections,
                     "base_epoch": self._base_epoch, "seq": seq,
                     "watermark": wm})
                self._delta_seq = seq
                self._delta_bytes += sum(a.nbytes
                                         for a in sections.values())
            self.writer.clear_checkpoint_dirty()
            self.stats.persists += 1
        except PersisterPoisoned:
            # a background commit failed: supersede the broken chain with a
            # synchronous full snapshot (which clears the poison)
            self.save()

    def _commit_job(self, job: dict) -> None:  # thread: worker
        """The persister worker's half: the file I/O, then (and only then)
        the journal truncation through the job's watermark, so records
        appended while the job was in flight survive to the next commit.

        Runs on the ``BackgroundPersister`` thread. It reads only
        attributes fixed before ``_start_persister()`` spawned the worker
        (``storage_dir``, ``journal``, ``snapshot_keep``) and the job, and
        publishes one thing back: the durable watermark, under
        ``_durable_lock``."""
        from repro_torch.checkpointing.snapshot import (write_delta_snapshot,
                                                        write_full_snapshot)
        from repro_torch.runtime.faultinject import crashpoint
        if job["kind"] == "full":
            # hippolint: disable=locks -- storage_dir is rebound only by
            # _adopt_storage, which runs before _start_persister spawns
            # this worker; it is immutable for the persister's lifetime
            write_full_snapshot(self.storage_dir, job["sections"],
                                keep=self.snapshot_keep,
                                epoch=job["epoch"], compact=job["compact"])
        else:
            write_delta_snapshot(self.storage_dir, job["sections"],
                                 job["base_epoch"], job["seq"])
        crashpoint("truncate.pre")
        # hippolint: disable=locks -- journal is rebound only by
        # _adopt_storage before _start_persister spawns this worker; the
        # Journal object itself is internally locked (wal.py)
        self.journal.truncate_through(job["watermark"])
        with self._durable_lock:
            self._durable_watermark = job["watermark"]

    def _truncate_journal(self, wm: int) -> None:
        """Journal clean-up after a commit: a quiet journal (nothing
        appended past the watermark) resets outright; otherwise only records
        at or below the watermark are dropped."""
        from repro_torch.runtime.faultinject import crashpoint
        crashpoint("truncate.pre")
        if self.journal.last_seqno == wm:
            self.journal.reset()
        else:
            self.journal.truncate_through(wm)
        with self._durable_lock:
            self._durable_watermark = wm

    def _note_full(self, path, epoch: int) -> None:
        self._base_epoch = epoch
        self._delta_seq = 0
        self._full_bytes = (path / "index.bin").stat().st_size
        self._delta_bytes = 0

    def _note_delta(self, path, seq: int) -> None:
        self._delta_seq = seq
        self._delta_bytes += (path / "index.bin").stat().st_size

    def _start_persister(self) -> None:
        if self.background_save and self.storage_dir is not None \
                and self._persister is None:
            from repro_torch.runtime.persister import BackgroundPersister
            self._persister = BackgroundPersister(
                self._commit_job, max_queue=self.persist_queue)

    def save(self):
        """Synchronous full durable commit: snapshot the whole index (staged
        queues included), fold any delta chain into the new base, truncate
        the journal. Returns the committed snapshot directory. Needs
        ``storage_dir``. After a failed background commit this supersedes
        the broken chain and re-enables background persistence."""
        if self.storage_dir is None:
            raise RuntimeError("save() needs storage_dir (durable mode); "
                               "writer-less indexes persist via index.save()")
        if self._persister is not None:
            # settle in-flight commits first; if one failed, this full
            # snapshot is about to supersede the whole chain anyway
            self._persister.flush(raise_on_poison=False)
        wm = self.journal.last_seqno
        epoch = (self._base_epoch or 0) + 1
        path = self.index.save(self.storage_dir, wal_seqno=wm,
                               keep=self.snapshot_keep, epoch=epoch,
                               compact=self._delta_seq > 0)
        self._note_full(path, epoch)
        self.writer.clear_checkpoint_dirty()
        if self._persister is not None:
            self._persister.clear_poison()
        self._truncate_journal(wm)
        self.stats.persists += 1
        return path

    def flush_durable(self) -> None:
        """Barrier: return once every submitted background commit is on
        disk (a no-op without ``background_save``). Raises
        ``PersisterPoisoned`` if a background commit failed; ``save()``
        supersedes the broken chain."""
        if self._persister is not None:
            self._persister.flush()

    def close(self) -> None:
        """Stop the background persister (flush + join) and close the
        journal's files. Safe to call more than once; the engine stays
        queryable, but durable commits stop."""
        if self._persister is not None:
            try:
                self._persister.flush(raise_on_poison=False)
            finally:
                self._persister.close()
            self._persister = None
        if self.journal is not None:
            self.journal.close()

    @classmethod
    def recover(cls, storage_dir, *, device=None, wal_sync: bool = True,
                snapshot_on_recover: bool = True, **kwargs) -> "QueryEngine":
        """Rebuild an engine from a durable directory after a crash, on
        ``device`` (None: the card): the latest committed snapshot and its
        delta chain (uncommitted partials are ignored, a gapped chain is
        refused), the journal's suffix replayed through a fresh writer, and
        the journal re-attached so later writes stay durable.
        ``snapshot_on_recover`` folds all of it into a fresh full base at
        once. ``kwargs`` configure the engine as usual (``storage_dir``
        comes from the first argument)."""
        if "storage_dir" in kwargs or "writer" in kwargs:
            raise ValueError("recover() derives storage_dir and writer from "
                             "the durable directory itself")
        from repro_torch.checkpointing.snapshot import recover_index
        idx, writer, journal = recover_index(storage_dir, wal_sync=wal_sync,
                                             device=device)
        if writer is None:
            writer = MaintenanceWriter(idx)
            writer.journal = journal
        eng = cls(idx, writer=writer, **kwargs)
        eng._adopt_storage(Path(storage_dir), journal)
        eng._sync_writer_stats()
        if snapshot_on_recover:
            eng.save()
        return eng

    def _adopt_storage(self, root, journal) -> None:
        """Attach existing durable state (the recover() path): the on-disk
        base epoch, the chain's position and its byte counts, so the
        compaction policy resumes where the crashed process left off."""
        from repro_torch.checkpointing.snapshot import (latest_delta_seq,
                                                        latest_epoch)
        self.storage_dir = root
        self.journal = journal
        if self.writer.journal is None:
            self.writer.journal = journal
        self._base_epoch = latest_epoch(root)
        self._delta_seq = (latest_delta_seq(root, self._base_epoch)
                           if self._base_epoch is not None else 0)
        if self._base_epoch is not None:
            self._full_bytes = (root / f"snap_{self._base_epoch}"
                                / "index.bin").stat().st_size
            self._delta_bytes = sum(
                (root / f"delta_{self._base_epoch}_{k}"
                 / "index.bin").stat().st_size
                for k in range(1, self._delta_seq + 1))
        # until the next commit records a watermark, persist_lag reports
        # the whole surviving journal as not yet snapshotted
        with self._durable_lock:
            self._durable_watermark = 0
        self._start_persister()

    def _sync_writer_stats(self) -> None:
        w = self.writer
        st = self.stats
        if self.journal is not None:
            with self._durable_lock:
                wm = self._durable_watermark
            st.persist_lag = max(0, self.journal.last_seqno - wm)
        if self._persister is not None:
            st.persist_pending = self._persister.pending
        st.drains = w.stats.drains
        st.drained_rows = w.stats.drained_rows
        st.drain_us = w.stats.total_drain_us
        st.queue_depth = w.queue_depth
        st.staged_rows = w.staged_rows
        st.peak_queue_depth = max(st.peak_queue_depth, w.queue_depth)
        st.resummarizes = w.stats.resummarizes
        st.edge_overflow_ratio = w.drift.edge_overflow_ratio
        st.learned_refits = w.stats.learned_refits
        st.learned_fallbacks = w.stats.learned_fallbacks

    def _maybe_drain_between_batches(self) -> None:
        """The between-batches drain. A refusal (shard slot capacity) raises
        once, then suspends auto-draining so queries keep serving exactly
        through the overlay; a successful ``flush()`` re-arms it."""
        if (self.writer is None or self.drain_policy != "between_batches"
                or self._auto_drain_suspended
                or not self.writer.pending_units):
            return
        try:
            with span("hippo.engine.drain"):
                self._drain(self.drain_units)
        except RuntimeError:
            self._auto_drain_suspended = True
            raise

    # -- execution ------------------------------------------------------------

    def run_batch(self) -> list[QueryTicket]:
        """Admit queued queries into free slots and execute one batch (in
        routed mode, one dispatch per matched shard). Returns the tickets
        retired by this batch. Under ``between_batches`` the drain runs
        first, so a refusal raises before any query work."""
        with span("hippo.engine.batch"):
            self._maybe_drain_between_batches()
            self._admit()
            active = [i for i, t in enumerate(self.slots) if t is not None]
            if not active:
                return []
            row_ids = None
            if self.mode == "compact":
                counts, inspected, matched, row_ids = \
                    self._execute_compact(active)
            elif self.sharded:
                counts, inspected, matched = self._execute_sharded(active)
            else:
                counts, inspected, matched = self._execute_dense(active)
            finished = []
            with span("hippo.engine.retire"):
                for k, i in enumerate(active):
                    t = self.slots[i]
                    t.count = int(counts[k])
                    t.pages_inspected = int(inspected[k])
                    t.entries_matched = int(matched[k])
                    if row_ids is not None:
                        ids = row_ids[k]
                        t.row_ids = ids[ids >= 0].copy()   # strip the pads
                    t.done = True
                    finished.append(t)
                    self.slots[i] = None          # recycle the slot
            self.stats.batches += 1
            if not self.sharded:
                # compact and fused dense modes dispatch the full batch
                # width; the routed dispatch accounts per shard in
                # _execute_sharded
                self.stats.slots_filled += len(active)
                self.stats.pad_slots += self.batch - len(active)
            self.stats.served += len(finished)
            return finished

    def _execute_dense(self, active: list[int]) -> tuple:
        """One full-width dense batch; pads fill the free slots."""
        preds = [t.pred if t is not None else _EMPTY for t in self.slots]
        res = self.index.search_batch(preds)
        out = torch.stack([res.counts, res.pages_inspected,
                           res.entries_matched]).cpu().numpy()
        return out[0][active], out[1][active], out[2][active]

    def _execute_sharded(self, active: list[int]) -> tuple:
        """Routed dispatch with summary pruning and count-reduce.

        The batch converts once per bounds epoch (``plan_batch``, (S, Q, W)
        on the device); shard s then runs ``search_batch_shard_arrays`` over
        only the queries whose bitmaps share a bucket with its summary,
        padded with zero bitmaps and empty (lo=1, hi=0) intervals to a
        power-of-two width of at least ``_SHARD_BUCKET_MIN``. A pruned
        (query, shard) pair is provably count-zero, and shards partition the
        pages, so the per-query sums are exact.
        """
        preds = [self.slots[i].pred for i in active]
        qbms, los, his, match = self.index.plan_batch(preds)
        a = len(active)
        counts = np.zeros((a,), np.int64)
        inspected = np.zeros((a,), np.int64)
        matched = np.zeros((a,), np.int64)
        st = self.stats
        for s in range(self.index.num_shards):
            hit = np.flatnonzero(match[:, s])
            n = int(hit.size)
            if n == 0:
                st.shards_pruned += 1
                continue
            width = _pow2_at_least(max(n, _SHARD_BUCKET_MIN))
            idx = torch.from_numpy(hit).to(qbms.device)
            qb = qbms.new_zeros((width, qbms.shape[2]))
            qb[:n] = qbms[s, idx]                 # shard s's epoch conversion
            lo = torch.full((width,), _EMPTY.lo, dtype=torch.float32,
                            device=los.device)
            hi = torch.full((width,), _EMPTY.hi, dtype=torch.float32,
                            device=his.device)
            lo[:n] = los[idx]
            hi[:n] = his[idx]
            res = self.index.search_batch_shard_arrays(s, qb, lo, hi)
            out = torch.stack([res.counts, res.pages_inspected,
                               res.entries_matched])[:, :n].cpu().numpy()
            counts[hit] += out[0]
            inspected[hit] += out[1]
            matched[hit] += out[2]
            st.shard_dispatches += 1
            st.slots_filled += n
            st.pad_slots += width - n
            st.shard_queries[s] = st.shard_queries.get(s, 0) + n
            st.shard_slots[s] = st.shard_slots.get(s, 0) + width
        # Staged rows belong to no entry yet, so summary routing cannot see
        # them: their counts add on top. Read from the index's attached
        # writer, which a sync engine or a superseded writer's engine must
        # see too.
        staging = getattr(self.index, "staging", None)
        if staging is not None and staging.staged_rows:
            counts += staging.staged_counts(los.cpu().numpy(),
                                            his.cpu().numpy()).sum(axis=1)
        return counts, inspected, matched

    def _execute_compact(self, active: list[int]) -> tuple:
        """The compact ladder: gather-path batch at the current slab bucket,
        widen the bucket when the union overflows it, and re-run this
        batch's truncated queries at the never-truncating cap.
        ``pages_inspected``/``entries_matched`` come from the first run (they
        are exact before the gather); counts and row ids are patched from
        the fallback."""
        preds = [t.pred if t is not None else _EMPTY for t in self.slots]
        cap = self.index.gather_cap
        bucket = min(self._compact_bucket, cap)
        res = self.index.search_compact_batch(preds, max_selected=bucket,
                                              top_k=self.top_k)
        with span("hippo.engine.readback"):
            counts = res.counts.cpu().numpy().copy()
            inspected = res.pages_inspected.cpu().numpy()
            matched = res.entries_matched.cpu().numpy()
            trunc = res.truncated.cpu().numpy()
            row_ids = (res.row_ids.cpu().numpy().copy() if self.top_k
                       else None)
            st = self.stats
            st.compact_batches += 1
            shards = getattr(self.index, "num_shards", 1)
            self._account_compact_dispatch(res, bucket * shards)
            needed = int(res.bucket_needed)
        if needed > bucket:
            self._compact_bucket = min(_pow2_at_least(needed), cap)
        bad = [i for i in active if trunc[i]]
        if bad:
            with span("hippo.engine.fallback"):
                st.compact_fallbacks += len(bad)
                width = _pow2_at_least(max(len(bad), _FALLBACK_Q_MIN))
                fb_preds = [self.slots[i].pred for i in bad]
                fb_preds += [_EMPTY] * (width - len(bad))
                fb = self.index.search_compact_batch(
                    fb_preds, max_selected=cap, top_k=self.top_k)
                st.slots_filled += len(bad)
                st.pad_slots += width - len(bad)
                self._account_compact_dispatch(fb, cap * shards)
                if bool(fb.truncated[: len(bad)].any()):
                    raise RuntimeError(
                        "compact fallback truncated at the full gather cap "
                        "— the slab no longer covers the table (was the "
                        "index mutated mid-batch?)")
                fb_counts = fb.counts.cpu().numpy()
                fb_ids = (fb.row_ids.cpu().numpy() if row_ids is not None
                          else None)
                for k, i in enumerate(bad):
                    counts[i] = fb_counts[k]
                    if row_ids is not None:
                        row_ids[i] = fb_ids[k]
        st.compact_hits += len(active) - len(bad)
        return (counts[active], inspected[active], matched[active],
                row_ids[active] if row_ids is not None else None)

    def _account_compact_dispatch(self, res, slab_capacity: int) -> None:
        """Fold one gather dispatch (primary batch or truncation fallback)
        into the gather telemetry."""
        st = self.stats
        st.gather_union_pages += int(res.pages_gathered)
        st.gather_slab_pages += slab_capacity
        st.selected_pages += int(res.pages_selected)
        st.table_pages_seen += self.index.table.num_pages
        st.window_selected_pages += int(res.pages_selected)
        st.window_table_pages += self.index.table.num_pages

    def drain(self) -> list[QueryTicket]:
        """Run batches until the queue and all slots are empty."""
        finished = []
        while self.queue or any(t is not None for t in self.slots):
            finished.extend(self.run_batch())
        return finished

    def run_all(self, preds: list[Predicate]) -> np.ndarray:
        """Submit + drain convenience; counts in submission order."""
        tickets = [self.submit(p) for p in preds]
        self.drain()
        return np.asarray([t.count for t in tickets], np.int64)
