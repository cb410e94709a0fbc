"""Port parity: self-healing recovery (``repro_torch.runtime.fault``) at
every registered crash site.

A crash injected at each site of the port's ``faultinject.SITES`` (which
must equal the reference's) recovers through the port's
``resilient_serve`` on ``device="cpu"`` to exactly the acknowledged
counts: brute force over the base rows plus every write the client saw
acknowledged. The reference runs the same workload with the same site
armed, and both packages must have acknowledged the same writes and
recover the same counts and crash statistics. Then the supervisor's own
cases (a watchdog-flagged hang, the retry budget, the backoff), the
crash-point registry and the persister's locked counters.
"""
import threading
import time
from collections import deque

import numpy as np
import pytest

from repro.core.partition import ShardedHippoIndex as JSharded
from repro.core.predicate import Predicate as JPred
from repro.runtime import faultinject as jfi
from repro.runtime.engine import QueryEngine as JEngine
from repro.runtime.fault import resilient_serve as jserve
from repro.storage.table import PagedTable as JTable
from repro_torch.core.partition import ShardedHippoIndex as TSharded
from repro_torch.core.predicate import Predicate as TPred
from repro_torch.runtime.engine import QueryEngine as TEngine
from repro_torch.runtime.fault import StepWatchdog, resilient_serve
from repro_torch.runtime.faultinject import (SITES, CrashPoints,
                                             InjectedCrash, crash_points)
from repro_torch.runtime.persister import BackgroundPersister
from repro_torch.storage.table import PagedTable as TTable

pytestmark = pytest.mark.fault

_ENGINE_KW = dict(batch=8, drain_policy="manual", auto_resummarize=False,
                  wal_sync=False)
# Site -> the durable engine whose commit path runs that site; keyed by
# SITES itself, so a new site without a configuration fails the sweep
_SITE_CONFIG = {
    "wal.pre_append": {},
    "drain.pre_swap": {},
    "delta.pre_commit": {},
    "snapshot.pre_commit": {"snapshot_mode": "full"},
    "compact.pre_commit": {"compact_every": 2},
    "truncate.pre": {},
    "persist.in_flight": {"background_save": True},
}
SPANS = [(5.0, 1.0), (20.0, 24.0), (100.0, 115.0), (80.0, 125.0),
         (-1e30, 1e30)]


@pytest.fixture(autouse=True)
def _clean_crash_points():
    crash_points.reset()
    jfi.crash_points.reset()
    yield
    crash_points.reset()
    jfi.crash_points.reset()


def _tidx(values):
    return TSharded.create(TTable.from_values(np.asarray(values), 8,
                                              spare_pages=256),
                           num_shards=4, resolution=32, density=0.25,
                           device="cpu")


def _value_brute(values, spans):
    v = np.asarray(values, np.float32)
    return np.asarray([((v >= lo) & (v <= hi)).sum() for lo, hi in spans],
                      np.int64)


def _acked_workload(values, acked, chunk=6):
    """A resumption-aware client: the cursor advances only when a write
    returns (is acknowledged); each step flushes (drain + commit)."""
    cursor = {"i": 0}

    def workload(eng):
        end = min(cursor["i"] + chunk, len(values))
        while cursor["i"] < end:
            v = values[cursor["i"]]
            eng.write(v)                 # raises => not acknowledged
            acked.append(v)
            cursor["i"] += 1
        eng.flush()
        return cursor["i"] >= len(values)

    return workload


def test_sites_equal_the_reference_registry():
    assert SITES == jfi.SITES
    assert set(_SITE_CONFIG) == set(SITES)


def _sweep(site, root, base, writes, package):
    """One site through one package's supervisor: (acked, counts after
    the flush, counts of a fresh recovery from disk, stats, fired)."""
    if package == "port":
        idx, engine, serve, fi, pred = _tidx(base), TEngine, \
            resilient_serve, crash_points, TPred
        rkw = dict(_ENGINE_KW, device="cpu", **_SITE_CONFIG[site])
    else:
        idx = JSharded.create(JTable.from_values(np.asarray(base), 8,
                                                 spare_pages=256),
                              num_shards=4, resolution=32, density=0.25)
        engine, serve, fi, pred = JEngine, jserve, jfi.crash_points, JPred
        rkw = dict(_ENGINE_KW, **_SITE_CONFIG[site])
    kw = dict(_ENGINE_KW, **_SITE_CONFIG[site])
    eng = engine(idx, storage_dir=root, **kw)
    acked = []
    fi.arm(site, times=1)
    eng2, stats = serve(root, _acked_workload(writes, acked), engine=eng,
                        recover_kwargs=rkw, max_restarts=6,
                        backoff_base_s=0.001)
    fired = fi.fired(site)
    if site == "persist.in_flight":
        eng2.flush_durable()
    eng2.flush()
    ps = [pred.between(lo, hi) for lo, hi in SPANS]
    counts = eng2.run_all(ps)
    eng2.close()
    again = engine.recover(root, snapshot_on_recover=False,
                           **({**rkw, **{"background_save": False}}))
    again.flush()
    fresh = again.run_all(ps)
    again.close()
    return acked, counts, fresh, stats, fired


@pytest.mark.parametrize("site", SITES)
def test_crash_at_every_registered_site_self_heals(tmp_path, site):
    rng = np.random.default_rng(SITES.index(site))
    base = np.sort(rng.uniform(0, 100, 160))
    writes = [float(v) for v in rng.uniform(100, 130, 36)]
    acked, counts, fresh, stats, fired = _sweep(
        site, tmp_path / "port", base, writes, "port")
    assert fired >= 1, f"{site} was never on the executed path"
    want = _value_brute(list(base) + acked, SPANS)
    assert acked == writes
    np.testing.assert_array_equal(counts, want, err_msg=site)
    np.testing.assert_array_equal(fresh, want, err_msg=site)
    if site == "persist.in_flight":
        assert stats.restores == 0 and stats.crashes == 0
    else:
        assert stats.crashes + stats.hangs >= 1 and stats.restores >= 1
    jacked, jcounts, jfresh, jstats, jfired = _sweep(
        site, tmp_path / "reference", base, writes, "reference")
    assert (jacked, jfired) == (acked, fired)
    np.testing.assert_array_equal(jcounts, counts)
    np.testing.assert_array_equal(jfresh, fresh)
    assert (jstats.steps, jstats.crashes, jstats.restores, jstats.hangs) == \
        (stats.steps, stats.crashes, stats.restores, stats.hangs)


def test_watchdog_hang_restarts_through_the_same_path(tmp_path):
    rng = np.random.default_rng(11)
    base = np.sort(rng.uniform(0, 100, 120))
    root = tmp_path / "dur"
    eng = TEngine(_tidx(base), storage_dir=root, **_ENGINE_KW)
    writes = [float(v) for v in rng.uniform(100, 120, 8)]
    for v in writes:
        eng.write(v)
    eng.flush()
    hung = {"done": False}

    def workload(e):
        if not hung["done"] and len(wd.times) >= 3:
            hung["done"] = True
            time.sleep(0.5)          # the hang: >> 3x the ~2 ms median
        else:
            time.sleep(0.002)
        return hung["done"] and len(wd.times) >= 5

    wd = StepWatchdog(threshold=3.0, window=8, min_samples=3)
    eng2, stats = resilient_serve(root, workload, engine=eng,
                                  recover_kwargs=dict(_ENGINE_KW,
                                                      device="cpu"),
                                  watchdog=wd, max_restarts=3,
                                  backoff_base_s=0.001)
    assert stats.hangs >= 1 and stats.restores >= 1 and stats.crashes == 0
    assert eng2.index.device.type == "cpu"
    np.testing.assert_array_equal(
        eng2.run_all([TPred.between(lo, hi) for lo, hi in SPANS]),
        _value_brute(list(base) + writes, SPANS))


def test_retry_budget_exhaustion_reraises(tmp_path):
    root = tmp_path / "dur"
    eng = TEngine(_tidx(np.sort(np.random.default_rng(12).uniform(0, 100,
                                                                  80))),
                  storage_dir=root, **_ENGINE_KW)
    calls = {"n": 0}

    def doomed(e):
        calls["n"] += 1
        raise RuntimeError("unrecoverable workload bug")

    with pytest.raises(RuntimeError, match="unrecoverable"):
        resilient_serve(root, doomed, engine=eng,
                        recover_kwargs=dict(_ENGINE_KW, device="cpu"),
                        max_restarts=2, backoff_base_s=0.001)
    assert calls["n"] == 3


def test_backoff_grows_exponentially_and_caps(tmp_path):
    root = tmp_path / "dur"
    eng = TEngine(_tidx(np.sort(np.random.default_rng(13).uniform(0, 100,
                                                                  80))),
                  storage_dir=root, **_ENGINE_KW)
    delays: list[float] = []
    remaining = {"n": 4}

    def flaky(e):
        if remaining["n"]:
            remaining["n"] -= 1
            raise RuntimeError("transient")
        return True

    _, stats = resilient_serve(root, flaky, engine=eng,
                               recover_kwargs=dict(_ENGINE_KW, device="cpu"),
                               max_restarts=8, backoff_base_s=0.01,
                               backoff_cap_s=0.04, sleep=delays.append)
    assert delays == [0.01, 0.02, 0.04, 0.04]
    assert stats.backoff_s == pytest.approx(sum(delays))
    assert stats.crashes == 4 and stats.restores == 4


# ---------------------------------------------------------------------------
# Harness units: the registry, the watchdog window, the persister's locks
# ---------------------------------------------------------------------------

def test_crash_points_arm_fire_reset_and_refuse():
    cp = CrashPoints()
    cp.arm("truncate.pre", times=2)
    for _ in range(2):
        with pytest.raises(InjectedCrash) as ei:
            cp.hit("truncate.pre")
        assert ei.value.site == "truncate.pre"
    cp.hit("truncate.pre")
    assert cp.fired("truncate.pre") == 2 and cp.fired("wal.pre_append") == 0
    with pytest.raises(ValueError, match="unknown crash site"):
        cp.arm("no.such.site")
    with pytest.raises(ValueError, match="unknown crash site"):
        cp.hit("no.such.site")
    with pytest.raises(ValueError, match=">= 1"):
        cp.arm("truncate.pre", times=0)
    cp.arm("drain.pre_swap")
    cp.reset()
    cp.hit("drain.pre_swap")
    assert cp.fired("drain.pre_swap") == 0


def test_watchdog_window_is_bounded_deque():
    wd = StepWatchdog(threshold=2.0, window=16, min_samples=3)
    assert isinstance(wd.times, deque) and wd.times.maxlen == 16
    for i in range(100):
        wd.observe(i, 0.01)
    assert len(wd.times) == 16
    assert wd.observe(100, 0.05) is True
    assert wd.flagged and wd.flagged[-1][0] == 100
    assert wd.observe(101, 0.012) is False


def test_persister_stats_snapshot_is_locked_copy():
    gate = threading.Event()
    p = BackgroundPersister(lambda job: gate.wait(5.0), max_queue=2)
    try:
        p.submit({"n": 1})
        s = p.stats_snapshot()
        assert (s.submitted, s.committed, s.failed) == (1, 0, 0)
        gate.set()
        p.flush()
        s2 = p.stats_snapshot()
        assert (s2.submitted, s2.committed, s2.failed) == (1, 1, 0)
        s2.committed = 999
        assert p.stats_snapshot().committed == 1 and p.pending == 0
    finally:
        gate.set()
        p.close()


def test_persister_counters_exact_under_concurrent_reads():
    p = BackgroundPersister(lambda job: None, max_queue=2)
    try:
        for i in range(200):
            p.submit(i)
            s = p.stats_snapshot()
            assert s.committed <= s.submitted == i + 1
            assert s.failed == 0 and p.pending >= 0 and not p.poisoned
        p.flush()
        s = p.stats_snapshot()
        assert (s.submitted, s.committed, s.failed) == (200, 200, 0)
    finally:
        p.close()
    with pytest.raises(RuntimeError, match="closed"):
        p.submit(1)
