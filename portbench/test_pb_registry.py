"""The harness finds cells, mixes and metric readers by name, and a cell,
a configuration and a metric are added with new files and new
BENCHMARK.json entries alone."""
import json
import re
import shutil
import time

import pytest

import pb_harness
import pb_registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = pb_registry.load_benchmark()


def test_every_cell_resolves_to_its_files():
    for w in BENCH["workloads"]:
        cell = pb_registry.find_cell(w["name"])
        assert cell.chips == w["chips"] == 1
        assert cell.config["name"] == w["config"]
        assert cell.traffic["reads"]["loop"] in ("open", "closed")
        for m in cell.end_to_end + cell.per_layer:
            assert callable(pb_registry.load_reader(m["name"]))
    with pytest.raises(KeyError):
        pb_registry.find_cell("no.such.cell")


def test_benchmark_json_keeps_to_its_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        list(e2e) + [m["name"] for m in BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        for cell in m.get("workloads", [w["name"] for w in
                                         BENCH["workloads"]]):
            assert pb_registry.reports(e2e[m["moves"]], cell)
    for w in BENCH["workloads"]:
        cell = pb_registry.find_cell(w["name"])
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and cell.per_layer
        assert len(w["why"]) <= 200


def test_a_cell_config_mix_and_metric_added_as_files(tmp_path, tiny):
    root = tmp_path / "checkout"
    shutil.copytree(pb_registry.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads((pb_registry.ROOT / bench["configs"][0]["file"])
                     .read_text())
    cfg.update(name="tiny_dbgen", rows=6000)
    (root / "portbench" / "configs" / "tiny_dbgen.json").write_text(
        json.dumps(cfg))
    (root / "portbench" / "traffic" / "point.json").write_text(json.dumps(
        {"reads": {"loop": "closed", "outstanding": 64, "widths": [1],
                   "recent_share": 0.0, "top_k": 0}, "writes": None}))
    (root / "portbench" / "metrics" / "batches_run.py").write_text(
        "def read(run):\n    return run.engine['batches']\n")
    bench["configs"].append({"name": "tiny_dbgen", "source": "a test",
                             "file": "portbench/configs/tiny_dbgen.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.point", "config": "tiny_dbgen",
                               "traffic": "point", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "batches_run", "unit": "batches",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["tiny.point"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = pb_registry.find_cell("tiny.point", root)
    assert cell.config["rows"] == 6000
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "batches_run"]
    out = pb_harness.run_cell(tiny(cell, rows=6000), 11, 0.4, False, "cpu",
                              time.perf_counter(), log=lambda s: None)
    assert out["correct"]
    assert out["metrics"]["batches_run"]["value"] > 0
    assert out["metrics"]["batches_run"]["unit"] == "batches"
