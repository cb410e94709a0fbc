"""Fault tolerance: step watchdog, checkpoint-restart loop, and the
self-healing engine supervisor (a copy of ``repro.runtime.fault`` against
the port's ``QueryEngine``).

Three layers, smallest to largest:

  * ``StepWatchdog`` — hang/straggler detection from host-observed step
    times: a robust (median-based) estimate over a bounded window flags
    steps exceeding ``threshold x`` the median. At pod scale a straggler
    shows up exactly as step-time inflation, and the mitigation is
    restart-from-checkpoint (JAX's multi-controller runtime cannot drop a
    single host without re-initializing the mesh); at serving scale a
    "step" is one workload slice — a batch of queries plus its drain — and
    a flagged step means the drain or a durable commit hung.
  * ``resilient_loop`` — the training-shaped wrapper: run
    ``step_fn(step, state) -> state`` with periodic ``save_fn`` and
    restore-on-exception. Determinism comes from the stateless
    step->batch mapping, so a replayed step consumes identical data.
  * ``resilient_serve`` — the serving-shaped supervisor this repo's
    durability layer actually needs: wrap a workload over a durable
    ``QueryEngine`` so that a crash (any exception — including an
    injected ``faultinject.InjectedCrash`` standing in for process
    death) or a watchdog-flagged hang tears the engine down and rebuilds
    it from disk via ``QueryEngine.recover(storage_dir)`` — snapshot +
    delta chain + WAL replay — with a retry budget and exponential
    backoff. No operator action: the loop owns the restart.

``resilient_serve``'s workload is a callable ``workload(engine) -> bool``
returning True when finished. It must be *resumption-aware*: after a
crash the engine is rebuilt from durable state, so the workload should
track its own cursor and only advance it when an operation returns
(i.e. was acknowledged) — exactly the discipline a real ingest client
replaying un-acked requests follows. ``tests/test_torch_fault_recovery.py``
drives this against every registered crash site and asserts the
recovered counts match the acknowledged state bit-identically.
"""
from __future__ import annotations

import gc
import time
from collections import deque
from dataclasses import dataclass, field
from statistics import median
from typing import Callable


@dataclass
class StepWatchdog:
    """Detects hung/straggling steps from host-observed step times."""

    threshold: float = 3.0          # x median
    window: int = 32
    min_samples: int = 5
    times: deque = field(default_factory=deque)
    flagged: list = field(default_factory=list)

    def __post_init__(self):
        # bounded window as a deque: admission is O(1), where a list's
        # pop(0) made every observation O(window)
        self.times = deque(self.times, maxlen=self.window)

    def observe(self, step: int, dt: float) -> bool:
        """Record a step time; returns True if this step is a straggler."""
        self.times.append(dt)
        if len(self.times) < self.min_samples:
            return False
        med = median(self.times)
        slow = dt > self.threshold * med
        if slow:
            self.flagged.append((step, dt, med))
        return slow


@dataclass
class LoopStats:
    steps_run: int = 0
    failures: int = 0
    restores: int = 0
    stragglers: int = 0


def resilient_loop(*, num_steps: int, step_fn: Callable[[int, dict], dict],
                   state: dict, save_fn: Callable[[int, dict], None],
                   restore_fn: Callable[[], tuple[int, dict]],
                   checkpoint_every: int = 10, max_failures: int = 5,
                   watchdog: StepWatchdog | None = None,
                   start_step: int = 0) -> tuple[dict, LoopStats]:
    """Run ``step_fn(step, state) -> state`` with checkpoint/restart.

    On any exception: restore the last committed checkpoint and continue from
    its step. ``step_fn`` failures inject exactly like device faults in tests.
    """
    stats = LoopStats()
    wd = watchdog or StepWatchdog()
    step = start_step
    while step < num_steps:
        try:
            t0 = time.perf_counter()
            state = step_fn(step, state)
            dt = time.perf_counter() - t0
            if wd.observe(step, dt):
                stats.stragglers += 1
            stats.steps_run += 1
            step += 1
            if step % checkpoint_every == 0:
                save_fn(step, state)
        except Exception:
            stats.failures += 1
            if stats.failures > max_failures:
                raise
            step, state = restore_fn()
            stats.restores += 1
    save_fn(step, state)
    return state, stats


# ---------------------------------------------------------------------------
# Engine supervisor
# ---------------------------------------------------------------------------

@dataclass
class ServeStats:
    steps: int = 0        # workload steps completed (crashed steps excluded)
    attempts: int = 0     # engine builds (initial + every recovery)
    crashes: int = 0      # steps torn down by an exception
    hangs: int = 0        # steps torn down by the watchdog
    restores: int = 0     # successful rebuilds from durable state
    backoff_s: float = 0.0  # total restart backoff slept


class _HungStep(RuntimeError):
    """Internal: a watchdog flag under ``hang_restart`` tears the step down
    through the same restart path a crash takes."""


def resilient_serve(storage_dir, workload: Callable, *,
                    engine=None, recover_kwargs: dict | None = None,
                    max_restarts: int = 5, backoff_base_s: float = 0.01,
                    backoff_cap_s: float = 1.0,
                    watchdog: StepWatchdog | None = None,
                    hang_restart: bool = True,
                    sleep: Callable[[float], None] = time.sleep):
    """Serve ``workload(engine) -> bool`` until it returns True, rebuilding
    the engine from ``storage_dir`` after every crash or flagged hang.

    The supervisor loop: (re)build the engine via
    ``QueryEngine.recover(storage_dir, **recover_kwargs)`` when it has
    none, run one workload step under the watchdog's timer, and on any
    exception — from the step *or* from recovery itself — tear the engine
    down, sleep an exponentially growing backoff (``backoff_base_s`` to
    ``backoff_cap_s``), and go again. ``max_restarts`` bounds total
    restarts; exhausting the budget re-raises the last failure. An
    ``engine`` may be passed in to adopt a live one for the first step
    (its ``storage_dir`` is still where recovery reads after it dies).
    ``recover_kwargs`` carries the recovered engine's configuration,
    ``device`` included (None: the card).

    Returns ``(engine, ServeStats)`` with the engine that completed the
    final step still live.
    """
    recover_kwargs = dict(recover_kwargs or {})
    wd = watchdog or StepWatchdog()
    stats = ServeStats()
    restarts = 0
    if engine is not None:
        stats.attempts += 1
    while True:
        try:
            if engine is None:
                # recovery runs inside the try: a crash *during* recovery
                # (e.g. an armed crash site on the recover path) counts
                # against the same budget instead of escaping the loop
                from repro_torch.runtime.engine import QueryEngine
                # the dead engine's index and writer reference each other:
                # collect the cycle so its device memory is free before
                # the recovered index is uploaded
                gc.collect()
                stats.attempts += 1
                engine = QueryEngine.recover(storage_dir, **recover_kwargs)
                stats.restores += 1
            t0 = time.perf_counter()
            done = workload(engine)
            dt = time.perf_counter() - t0
            flagged = wd.observe(stats.steps, dt)
            stats.steps += 1
            if done:
                return engine, stats
            if flagged and hang_restart:
                stats.hangs += 1
                raise _HungStep(
                    f"step {stats.steps - 1} took {dt:.3f}s against a "
                    f"median-based budget — restarting from durable state")
        except Exception as e:
            if not isinstance(e, _HungStep):
                stats.crashes += 1
            restarts += 1
            if restarts > max_restarts:
                raise
            if engine is not None:
                try:
                    engine.close()
                except Exception:
                    pass     # a dying engine may fail to close cleanly
                engine = None
            delay = min(backoff_base_s * (2 ** (restarts - 1)),
                        backoff_cap_s)
            sleep(delay)
            stats.backoff_s += delay
