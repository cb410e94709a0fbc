"""The benchmark's CPU tests: the harness's modules and the port's package
on the path, a checkout that adds test cells for the harness's write path,
and a helper that cuts a cell to a size the CPU runs in seconds (the same
code paths; the port's kernels take their plain versions on CPU tensors).

``BENCHMARK.json``'s one writing cell, ``dbgen.refresh``, runs TPC-H's
refresh functions on the dbgen layout; the day-sorted layout with its
refresh stream ``streams/daily_retention.py`` (appends of the newest day, a
retention delete of the oldest) has no cell there (PERF.md, Open questions)
and is kept proven here: the test checkout adds ``daily.refresh`` (an open
loop beside the refresh stream) and ``daily.scan`` (a closed loop on the
sorted column, half the queries recent) to a copy of the benchmark.

It also adds configurations with an ``"engine"`` object
(``pb_harness.engine_kwargs``): ``daily.durable`` (``daily.refresh`` on a
durable engine: a journal record fsynced per write and range delete, a
delta committed per drain, judged again after a recovery),
``daily.journal`` (the same with no commit after the first full snapshot,
so recovery replays every record from the journal) and ``dbgen.dense``
(``dbgen.scan`` on the routed dense engine)."""
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
for p in (str(HERE), str(HERE.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

READS = {"widths": [1, 30, 90, 365], "recent_share": 0.5, "recent_days": 30,
         "top_k": 0}
TEST_MIXES = {
    "refresh": {"reads": dict(READS, loop="open", rate_qps=300),
                "writes": {"rate_rows_per_s": 300}},
    "recent_scan": {"reads": dict(READS, loop="closed", outstanding=256),
                    "writes": None},
}
TEST_CELLS = [("daily.refresh", "refresh"), ("daily.scan", "recent_scan")]
# (cell, configuration, base configuration, its "engine" object, mix)
ENGINE_CELLS = [
    ("daily.durable", "test_daily_durable", "test_daily",
     {"storage_dir": True, "wal_sync": True}, "refresh"),
    ("daily.journal", "test_daily_journal", "test_daily",
     {"storage_dir": True, "wal_sync": True, "snapshot_on_drain": False},
     "refresh"),
    ("dbgen.dense", "test_dbgen_dense", "tpch_sf10_shipdate_dbgen",
     {"mode": "dense"}, "scan"),
]


def _test_checkout(root: Path) -> Path:
    """A copy of ``portbench/`` and ``BENCHMARK.json`` under ``root`` with
    the day-sorted test configuration, its two mixes and two cells, and the
    cells of ``ENGINE_CELLS``."""
    import pb_registry
    shutil.copytree(pb_registry.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = pb_registry.load_benchmark()
    base = bench["configs"][0]
    cfg = json.loads((pb_registry.ROOT / base["file"]).read_text())
    cfg.update(name="test_daily", layout="daily", spare_pages=4096,
               refresh_stream="daily_retention",
               rows_per_day=cfg["rows"] // cfg["days"])
    (root / "portbench" / "configs" / "test_daily.json").write_text(
        json.dumps(cfg))
    for name, mix in TEST_MIXES.items():
        (root / "portbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    bench["configs"].append(dict(base, name="test_daily",
                                 file="portbench/configs/test_daily.json"))
    for name, mix in TEST_CELLS:
        bench["workloads"].append({"name": name, "config": "test_daily",
                                   "traffic": mix, "chips": 1, "why": "test"})
    files = {c["name"]: c["file"] for c in bench["configs"]}
    for name, config, base_name, engine, mix in ENGINE_CELLS:
        cfg = json.loads((root / files[base_name]).read_text())
        cfg.update(name=config, engine=engine)
        (root / "portbench" / "configs" / f"{config}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append(dict(base, name=config,
                                     file=f"portbench/configs/{config}.json"))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": mix, "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "read_qps":
            m["workloads"] += [name for name, _ in TEST_CELLS] \
                + [c[0] for c in ENGINE_CELLS]
        if m["name"] == "refresh_ack_ms":
            m["workloads"] += [c[0] for c in ENGINE_CELLS if c[4] == "refresh"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="session")
def test_root(tmp_path_factory):
    """The test checkout above (the benchmark's own cells included)."""
    return _test_checkout(tmp_path_factory.mktemp("checkout"))


def tiny(cell, rows: int = 12000, rate: float = 300.0):
    """Cut ``cell`` to ``rows`` rows (days keep their number; a day holds
    rows / days rows, and so does a day of the daily stream) and its open
    loop and refresh stream to ``rate``."""
    cell.config["rows"] = rows
    if "rows_per_day" in cell.config:
        cell.config["rows_per_day"] = max(rows // cell.config["days"], 1)
    if cell.traffic.get("writes"):
        cell.traffic["writes"]["rate_rows_per_s"] = rate
    if cell.traffic["reads"]["loop"] == "open":
        cell.traffic["reads"]["rate_qps"] = rate
    return cell


@pytest.fixture(name="tiny")
def tiny_fixture():
    """``tiny(cell, rows=..., rate=...)``: the cut above, as a fixture."""
    return tiny


@pytest.fixture
def run_tiny(test_root):
    """run_tiny(name, seconds=0.6, root=None, **kw) -> result dict, on the
    CPU, of a cell of the test checkout (or of ``root``)."""
    import pb_harness
    import pb_registry

    def run(name, seconds=0.6, root=None, seed=987654321987, **kw):
        cell = tiny(pb_registry.find_cell(name, root or test_root))
        return pb_harness.run_cell(cell, seed, seconds, False, "cpu",
                                   time.perf_counter(), log=lambda s: None,
                                   **kw)
    return run
