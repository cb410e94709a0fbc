"""The durable refresh cell, ``dbgen.refresh.durable``, on the CPU at a tiny
size: TPC-H's refresh pairs through ``streams/tpch_rf_orders.py`` (an RF1
order in one ``write_many``, an RF2 order in one ``delete_rows``) on an
engine that journals and fsyncs each before acknowledging it and takes no
snapshot after the first.

``BENCHMARK.json`` lists the cell on the configuration
``configs/tpch_sf10_shipdate_rf_durable.json`` under ``dbgen.refresh``'s
traffic, with every per-layer metric of ``dbgen.refresh`` and the three
readers of the journal below.

- The stream issues what ``tpch_rf`` issues, an order a call, and hands
  the reference the same changes.
- The cell runs correct, is judged again after a recovery with
  ``lost_on_recovery`` 0, and leaves no storage directory; its engine
  arguments carry ``snapshot_on_drain`` False.
- A traced run reads ``journal_sync_ms.durable`` and
  ``syncs_per_row.durable`` from the journal's counters, the latter equal
  to fsyncs over rows written plus rows deleted by id;
  ``idle_in_journal.durable`` reads the device idle inside the journal's
  spans, which ``idle_in_refresh.refresh`` then leaves out; each reads
  nothing without its counters or spans.
- An order whose group-insert record, or whose row-delete record, is
  dropped from the journal comes out not correct through
  ``lost_on_recovery`` alone.
"""
import os
import time

import numpy as np
import pytest
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent

import pb_data
import pb_harness
import pb_registry
import pb_trace
from pb_harness import Run, engine_kwargs

CELL = "dbgen.refresh.durable"
LAYER = "storage (checkpointing/wal.py, runtime/engine.py)"
# the per-layer entries the cell brings, as BENCHMARK.json lists them
JOURNAL_METRICS = [
    {"name": "journal_sync_ms.durable", "unit": "ms", "better": "lower",
     "source": "program_counter", "layer": LAYER, "moves": "refresh_ack_ms",
     "workloads": [CELL]},
    {"name": "syncs_per_row.durable", "unit": "syncs/row", "better": "lower",
     "source": "program_counter", "layer": LAYER, "moves": "refresh_ack_ms",
     "workloads": [CELL]},
    {"name": "idle_in_journal.durable", "unit": "%", "better": "lower",
     "source": "program_span", "layer": LAYER, "moves": "read_qps",
     "workloads": [CELL]}]
SEED = 3037000493123
METRICS = ("journal_sync_ms.durable", "syncs_per_row.durable",
           "idle_in_journal.durable")


class Recorder:
    """An engine that logs what a stream sends it."""

    def __init__(self):
        self.calls = []

    def write(self, v):
        self.calls.append(("w", [float(v)]))

    def write_many(self, values):
        self.calls.append(("w", [float(v) for v in values]))
        return len(values)

    def delete_rows(self, ids):
        self.calls.append(("d", np.asarray(ids).tolist()))


def _cell(root=pb_registry.ROOT) -> pb_registry.Cell:
    return pb_registry.find_cell(CELL, root)


def _run(root, tiny, seconds=0.6, trace=False, log=None):
    cell = tiny(_cell(root))
    return pb_harness.run_cell(cell, SEED, seconds, trace, "cpu",
                               time.perf_counter(),
                               log=log or (lambda s: None))


def _own_dirs(root) -> list:
    base = root / ".portbench_cache" / "storage"
    return list(base.glob(f"*.{os.getpid()}")) if base.is_dir() else []


def test_the_stream_sends_an_order_a_call_and_tpch_rf_s_changes():
    cell = _cell()
    base = pb_registry.find_cell("dbgen.refresh")
    assert cell.config["refresh_stream"] == "tpch_rf_orders"
    assert base.config["refresh_stream"] == "tpch_rf"
    cfg = dict(cell.config, rows=12000)
    data = pb_data.make_column(cfg, SEED, "cpu")
    orders = pb_registry.load_stream(cfg, SEED, data)
    rows = pb_registry.load_stream(dict(base.config, rows=12000), SEED, data)
    assert type(orders._rf).__module__ == type(rows).__module__
    for k in range(200):
        assert orders.op(k) == rows.op(k)
        assert orders.changes(k) == rows.changes(k)
        assert orders.rows(k) == rows.rows(k)
        a, b = Recorder(), Recorder()
        assert orders.issue(a, k) == rows.issue(b, k)
        assert len(a.calls) == 1
        kind, got = a.calls[0]
        assert [v for c in b.calls for v in c[1]] == got
        assert len(b.calls) == (len(got) if kind == "w" else 1)
    assert orders.due(np.arange(100.0), 3).tolist() == \
        rows.due(np.arange(100.0), 3).tolist()
    assert orders.ops_for_rows(512) == rows.ops_for_rows(512)


def test_benchmark_json_lists_the_cell_beside_dbgen_refresh():
    cell = _cell()
    base = pb_registry.find_cell("dbgen.refresh")
    bench = pb_registry.load_benchmark()
    [w] = [w for w in bench["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == \
        ("tpch_sf10_shipdate_rf_durable", "rf_pairs", 1)
    assert cell.end_to_end == base.end_to_end
    assert cell.per_layer == base.per_layer + JOURNAL_METRICS


def test_the_cell_s_engine_journals_every_order_and_never_commits_again():
    cell = _cell()
    kw = engine_kwargs(cell.config, cell.traffic, "run_dir")
    assert kw == {"batch": 64, "top_k": 0, "drain_policy": "between_batches",
                  "drain_units": 2, "storage_dir": "run_dir",
                  "wal_sync": True, "snapshot_on_drain": False}
    # dbgen.refresh's deployment and traffic, with durability added
    base = pb_registry.find_cell("dbgen.refresh")
    assert cell.traffic == base.traffic
    told = {"name", "deployment", "durability", "refresh_stream",
            "guarantees", "assumed"}
    for key, value in base.config.items():
        if key not in told:
            assert cell.config[key] == value, key
    assert set(cell.config) - set(base.config) == {"engine",
                                                   "durability_why"}
    g = cell.config["guarantees"]
    assert {k: g[k] for k in base.config["guarantees"]} == \
        base.config["guarantees"] and "durability" in g
    assert cell.config["assumed"][:len(base.config["assumed"])] == \
        base.config["assumed"]


def test_the_durable_cell_runs_correct_and_loses_nothing(test_root, tiny,
                                                         monkeypatch):
    from repro_torch.runtime.engine import QueryEngine
    calls = {"write": 0, "write_many": 0, "delete_rows": 0}
    for name in calls:
        orig = getattr(QueryEngine, name)

        def counted(self, *a, _orig=orig, _name=name):
            calls[_name] += 1
            return _orig(self, *a)
        monkeypatch.setattr(QueryEngine, name, counted)
    lines = []
    # two seconds: the first batches on a loaded CPU may take most of one
    out = _run(test_root, tiny, seconds=2.0, log=lines.append)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert "lost_on_recovery" in out["checks"]
    assert calls["write"] == 0
    assert calls["write_many"] > 30 and calls["delete_rows"] > 30, calls
    assert not _own_dirs(test_root)
    [line] = [s for s in lines if s.startswith("storage: ")]
    assert "persists 1 (0 in the window)" in line
    assert out["metrics"]["refresh_ack_ms"]["value"] > 0


def test_a_traced_run_reads_the_journal_s_counters(test_root, tiny,
                                                   monkeypatch):
    runs = []
    load = pb_harness.load_reader

    def spy(name, root):
        read = load(name, root)

        def reader(run):
            runs.append(run)
            return read(run)
        return reader
    monkeypatch.setattr(pb_harness, "load_reader", spy)
    out = _run(test_root, tiny, seconds=2.0, trace=True)
    assert out["correct"], out["checks"]
    run = runs[0]
    e, w = run.engine, run.writer
    rows = e["writes"] + w["rows_deleted"]
    assert e["journal_syncs"] > 10
    m = out["metrics"]
    assert m["syncs_per_row.durable"]["value"] == pytest.approx(
        e["journal_syncs"] / rows)
    # an order of 1-7 rows, ~4 on average, commits once
    assert 1 / 7 <= m["syncs_per_row.durable"]["value"] < 0.5
    assert m["journal_sync_ms.durable"]["value"] == pytest.approx(
        e["journal_sync_us"] / e["journal_syncs"] / 1e3)
    assert m["journal_sync_ms.durable"]["unit"] == "ms"
    # the CPU has no device to idle
    assert "idle_in_journal.durable" not in m


@pytest.mark.parametrize("metric", METRICS[:2])
def test_the_counter_readers_read_nothing_without_the_counters(metric):
    read = pb_registry.load_reader(metric)
    old = Run(setup_s=1.0, engine={"writes": 40, "drains": 3},
              writer={"rows_deleted": 12, "staged": 40})
    assert read(old) is None
    idle = Run(setup_s=1.0, engine={"writes": 0, "journal_syncs": 0,
                                    "journal_sync_us": 0.0},
               writer={"rows_deleted": 0})
    assert read(idle) is None


def _ev(name, a, b, device=False):
    return FunctionEvent(id=0, name=name, thread=1, start_us=a, end_us=b,
                         device_type=DeviceType.CUDA if device
                         else DeviceType.CPU)


# a 100 us window: device busy [0,5] [50,60]; one batch [10,40]; one write
# [60,90] holding the journal's append [62,66] and fsync [66,80]
EVENTS = [_ev("pb.window", 0, 100), _ev("pb.batch", 9, 41),
          _ev("pb.write", 59, 91),
          _ev("compact_inspect_kernel", 0, 5, device=True),
          _ev("Memcpy HtoD", 50, 60, device=True),
          _ev("hippo.engine.batch", 10, 40),
          _ev("hippo.engine.write", 60, 90)]
WAL = [_ev("hippo.wal.append", 62, 66), _ev("hippo.wal.sync", 66, 80)]


@pytest.mark.parametrize("events,journal,refresh", [
    (EVENTS + WAL, 18.0, 12.0), (EVENTS, None, 30.0)],
    ids=["journal_spans", "no_journal_spans"])
def test_idle_in_journal_reads_the_idle_inside_the_journal_s_spans(
        events, journal, refresh):

    class Done:
        def events(self):
            return events

    tracer = pb_trace.Tracer()
    tracer._done = Done()
    run = Run(setup_s=1.0, trace=pb_trace.read_events(events))
    got = pb_registry.load_reader("idle_in_journal.durable")(run)
    assert got == (pytest.approx(journal) if journal is not None else None)
    assert pb_registry.load_reader("idle_in_refresh.refresh")(run) == \
        pytest.approx(refresh)
    assert pb_registry.load_reader("idle_in_journal.durable")(
        Run(setup_s=1.0)) is None          # untraced


@pytest.mark.parametrize("kind", ["insert_group", "row_delete"])
def test_an_order_missing_from_the_journal_is_lost(test_root, tiny,
                                                   monkeypatch, kind):
    from repro_torch.checkpointing.wal import Journal
    orig = getattr(Journal, f"append_{kind}")
    seen = []

    def drop_one(self, *a):
        # the tenth record of the kind, in the warm-up's first orders
        seen.append(a)
        if len(seen) == 10:
            return self.last_seqno
        return orig(self, *a)
    monkeypatch.setattr(Journal, f"append_{kind}", drop_one)
    out = _run(test_root, tiny)
    assert len(seen) > 10
    assert not out["correct"]
    assert out["checks"]["lost_on_recovery"]["value"] >= 1
    assert out["checks"]["wrong_counts"]["value"] == 0
    assert out["checks"]["missing_answers"]["value"] == 0
    assert not _own_dirs(test_root)
