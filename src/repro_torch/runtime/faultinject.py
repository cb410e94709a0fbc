"""Crash-point injection registry (a copy of ``repro.runtime.faultinject``,
which the port cannot import).

Durability-bearing code declares its crash-critical instants by calling
``crashpoint("<site>")``, and tests arm a site to make that call raise
``InjectedCrash`` — the process-death stand-in — a bounded number of times.
An injected raise models the process dying at that instant. Arming is
thread-safe, and an unarmed ``crashpoint`` call is one dict lookup under a
lock. The site names are exactly the reference's: hippolint's crash pass
audits every ``crashpoint`` call against the first ``runtime/faultinject.py``
in sorted order, which is the reference's.

Registered sites (``SITES``) — each names the instant just *before* a
durability-ordering-critical action:

  wal.pre_append        before a journal record is written (an acknowledged
                        op must never be staged without its record)
  drain.pre_swap        after a drain's table appends, before the rebuilt
                        shard state is published
  delta.pre_commit      delta snapshot payload written, COMMITTED sentinel
                        not yet renamed in
  snapshot.pre_commit   same instant for a full snapshot
  compact.pre_commit    compaction fold payload written, sentinel pending
  truncate.pre          snapshot committed, journal not yet truncated
                        (the classic double-apply window)
  persist.in_flight     a background persister job picked up, nothing
                        written yet (the queued-but-not-durable window)

In the port, the maintenance writer's drain calls ``drain.pre_swap``; the
other sites belong to durable storage.
"""
from __future__ import annotations

import threading

def _register(*sites: str) -> tuple[str, ...]:
    """Build the registry, refusing duplicates at import time: a
    copy-pasted site name would silently shadow its twin — ``arm`` would
    arm both call sites at once — blinding the fault tier and the
    hippolint bijectivity audit alike."""
    seen: set[str] = set()
    for site in sites:
        if site in seen:
            raise ValueError(f"duplicate crash site {site!r} in SITES")
        seen.add(site)
    return sites


SITES = _register(
    "wal.pre_append",
    "drain.pre_swap",
    "delta.pre_commit",
    "snapshot.pre_commit",
    "compact.pre_commit",
    "truncate.pre",
    "persist.in_flight",
)


class InjectedCrash(RuntimeError):
    """An armed crash point fired — stands in for the process dying here."""

    def __init__(self, site: str):
        super().__init__(f"injected crash at {site!r}")
        self.site = site


class CrashPoints:
    """Armable registry of crash sites.

    ``arm(site, times=n)`` makes the next ``n`` ``hit(site)`` calls raise
    ``InjectedCrash``; further hits pass through (the recovered process is
    not re-killed, so a test observes exactly the crash it asked for).
    ``fired(site)`` counts the raises actually delivered — a test can
    assert its site was really on the executed path, not silently skipped.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._armed: dict[str, int] = {}
        self._fired: dict[str, int] = {}

    @staticmethod
    def _check(site: str) -> None:
        if site not in SITES:
            raise ValueError(f"unknown crash site {site!r}; registered "
                             f"sites: {', '.join(SITES)}")

    def arm(self, site: str, times: int = 1) -> None:
        self._check(site)
        if times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        with self._lock:
            self._armed[site] = times

    def disarm(self, site: str | None = None) -> None:
        """Disarm one site (or every site), keeping the fired counts."""
        with self._lock:
            if site is None:
                self._armed.clear()
            else:
                self._check(site)
                self._armed.pop(site, None)

    def reset(self) -> None:
        """Disarm everything and zero the fired counts (test isolation)."""
        with self._lock:
            self._armed.clear()
            self._fired.clear()

    def fired(self, site: str) -> int:
        self._check(site)
        with self._lock:
            return self._fired.get(site, 0)

    def hit(self, site: str) -> None:
        """The instrumented-code side: raise if ``site`` is armed."""
        self._check(site)
        with self._lock:
            remaining = self._armed.get(site, 0)
            if remaining <= 0:
                return
            if remaining == 1:
                self._armed.pop(site)
            else:
                self._armed[site] = remaining - 1
            self._fired[site] = self._fired.get(site, 0) + 1
        raise InjectedCrash(site)


# The process-wide default registry: production code calls the module-level
# ``crashpoint``; tests arm through ``crash_points`` (or build their own
# ``CrashPoints`` and swap it in for full isolation).
crash_points = CrashPoints()


def crashpoint(site: str) -> None:
    """Declare a crash-critical instant; no-op unless a test armed it."""
    crash_points.hit(site)
