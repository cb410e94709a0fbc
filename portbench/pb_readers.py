"""Shared arithmetic of the metric readers in ``portbench/metrics/``. A
reader returns None where its run has nothing to read; the harness then
leaves the metric out of the line."""
from __future__ import annotations

import numpy as np

import pb_bytes


def p95(x):
    return float(np.percentile(x, 95)) if x is not None and len(x) else None


def median(x):
    return float(np.median(x)) if x is not None and len(x) else None


def read_qps(run):
    return run.reads_done / run.window_s if run.reads_done else None


def batch_ms(run):
    return median(run.batch_ms)


def device_idle(run):
    """Percent of the traced window in which no operation ran on the
    device."""
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0


def selected_page_ratio(run):
    """Batch-union pages over table pages across the run's compact
    dispatches (EngineStats), in percent."""
    seen = run.engine.get("table_pages_seen", 0)
    return run.engine["selected_pages"] / seen * 100.0 if seen else None


def index_bytes_per_tuple(run):
    return run.index_bytes / run.live_tuples if run.live_tuples else None


def compact_inspect_roofline(run):
    """Kernel B's once-moved bytes over 3.35 TB/s against its summed device
    time in the traced part, in percent (the gathered pages are the
    traced part's EngineStats)."""
    calls = run.kernel_calls.get("compact_inspect")
    if not calls or run.trace is None:
        return None
    nbytes = pb_bytes.compact_inspect_bytes(
        calls, run.engine.get("gather_union_pages", 0), run.page_card)
    return pb_bytes.roofline_percent(
        nbytes, run.trace.kernel_seconds("compact_inspect_kernel"))


def batch_filter_sharded_roofline(run):
    """Kernel A's once-moved bytes over 3.35 TB/s against its summed device
    time in the traced part, in percent. The unsharded filter shares the
    kernel's name; a traced part that ran it reads nothing."""
    calls = run.kernel_calls.get("batch_filter_sharded")
    if not calls or run.trace is None \
            or run.kernel_calls.get("batch_filter_unsharded"):
        return None
    return pb_bytes.roofline_percent(
        pb_bytes.batch_filter_bytes(calls),
        run.trace.kernel_seconds("batch_filter_kernel"))
