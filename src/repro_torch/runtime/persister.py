"""Background persister — durable commits off the drain path (a copy of
``repro.runtime.persister``, which the port cannot import).

A synchronous ``QueryEngine.save()`` in the drain makes every drain commit
pay section collection *and* the fsync train before the next query batch
can run. Collection must stay foreground
(it reads the index, which the next drain mutates), but the file I/O need
not: the engine collects sections from the immutable post-swap state,
then hands the write to this module's single worker thread and keeps
serving.

Ordering discipline. Jobs commit strictly in submission order (one worker,
FIFO queue) — a delta's sequence number is reserved at collect time, and
``checkpointing.snapshot.delta_chain`` refuses gaps, so out-of-order
commits would be unloadable anyway. The WAL truncation belongs to the
*commit callback* (the job body), not the submitter: truncating at submit
time would destroy acknowledged records whose covering snapshot is still
in the queue — a crash in that window would lose them. The engine's
commit callback truncates only through the job's recorded watermark
(``Journal.truncate_through``), so records appended while the job was in
flight always survive to the next commit.

Poisoning. A failed commit must not be skipped over: if delta k fails and
delta k+1 were allowed to commit, the chain would either gap (refused at
load) or, worse, a later WAL truncation would discard records only delta
k covered. So the first failure *poisons* the persister — every queued
and future job fails fast with ``PersisterPoisoned`` without touching
disk — until the engine performs a synchronous full snapshot
(``QueryEngine.save()``), which supersedes the whole broken chain and
clears the poison. Acknowledged operations stay safe throughout: the WAL
is only ever truncated by a *successful* commit's callback.

Backpressure: the queue is bounded; ``submit`` blocks when the persister
falls ``max_queue`` commits behind (time spent blocked is surfaced via
``PersistStats.blocked_s`` and the engine's ``persist_lag`` stat), so an
unboundedly slow disk degrades the drain rate instead of growing an
unbounded pile of un-durable acknowledged state. ``flush()`` is the
barrier tests and ``QueryEngine.flush_durable()`` use.
"""
from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, replace

from repro_torch.runtime.faultinject import crashpoint

_STOP = object()


class PersisterPoisoned(RuntimeError):
    """A background commit failed; later commits are refused until a
    synchronous full snapshot supersedes the broken chain."""


@dataclass
class PersistStats:
    submitted: int = 0    # jobs accepted into the queue
    committed: int = 0    # jobs durably committed by the worker
    failed: int = 0       # jobs that raised (first one poisons)
    blocked_s: float = 0.0  # total submit-side backpressure wait


class BackgroundPersister:
    """One worker thread draining a bounded FIFO of commit jobs.

    ``commit_fn(job)`` does the durable work (write sections, commit
    sentinel, truncate WAL through the job's watermark); it runs on the
    worker thread only, one job at a time, in submission order.
    """

    def __init__(self, commit_fn, *, max_queue: int = 4,
                 name: str = "hippo-persister"):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._commit = commit_fn
        self._q: queue.Queue = queue.Queue(maxsize=max_queue)
        # guards the worker/caller shared state below; held only around
        # state flips and counter bumps, never across commit I/O, so a
        # slow disk cannot block a stats read
        self._lock = threading.Lock()
        self._poison: BaseException | None = None  # guarded-by: _lock
        self._closed = False
        self._inflight = False                     # guarded-by: _lock
        self.stats = PersistStats()                # guarded-by: _lock
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    # -- worker --------------------------------------------------------------

    def _run(self) -> None:
        while True:
            job = self._q.get()
            if job is _STOP:
                self._q.task_done()
                return
            with self._lock:
                poison = self._poison
                self._inflight = True
            try:
                if poison is not None:
                    # fail queued jobs *without* committing: committing past
                    # a failed commit is exactly the gap/loss poisoning
                    # exists to prevent
                    raise PersisterPoisoned(
                        "persister poisoned by an earlier failed commit"
                    ) from poison
                crashpoint("persist.in_flight")
                self._commit(job)
                with self._lock:
                    self.stats.committed += 1
            except BaseException as e:       # noqa: BLE001 — poison on any
                with self._lock:
                    self.stats.failed += 1
                    if self._poison is None:
                        self._poison = e
            finally:
                with self._lock:
                    self._inflight = False
                self._q.task_done()

    # -- submitter side ------------------------------------------------------

    def submit(self, job) -> None:
        """Enqueue one commit job; blocks (backpressure) when the queue is
        full. Raises ``PersisterPoisoned`` immediately if a prior commit
        failed — the caller must fall back to a synchronous full save."""
        if self._closed:
            raise RuntimeError("persister is closed")
        with self._lock:
            poison = self._poison
        if poison is not None:
            raise PersisterPoisoned(
                "persister poisoned by an earlier failed commit"
            ) from poison
        t0 = time.perf_counter()
        self._q.put(job)
        with self._lock:
            self.stats.blocked_s += time.perf_counter() - t0
            self.stats.submitted += 1

    def stats_snapshot(self) -> PersistStats:
        """A consistent copy of the counters, taken under the lock — the
        caller-thread way to read stats while the worker is bumping them."""
        with self._lock:
            return replace(self.stats)

    @property
    def pending(self) -> int:
        """Jobs not yet durably committed (queued + in flight)."""
        with self._lock:
            inflight = self._inflight
        return self._q.qsize() + (1 if inflight else 0)

    @property
    def poisoned(self) -> bool:
        with self._lock:
            return self._poison is not None

    def flush(self, *, raise_on_poison: bool = True) -> None:
        """Barrier: return once every submitted job has been processed.
        Surfaces the first failure (the poison) unless told not to."""
        self._q.join()
        with self._lock:
            poison = self._poison
        if raise_on_poison and poison is not None:
            raise PersisterPoisoned(
                "a background commit failed; acknowledged state past the "
                "last successful commit is covered by the WAL only"
            ) from poison

    def clear_poison(self) -> None:
        """Called after a synchronous full snapshot supersedes the broken
        chain — background commits may resume."""
        with self._lock:
            self._poison = None

    def close(self, timeout: float = 10.0) -> None:
        """Drain the queue, stop the worker, and join it."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_STOP)
        self._thread.join(timeout=timeout)
