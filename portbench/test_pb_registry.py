"""The harness finds cells, mixes, metric readers and refresh streams by
name, and a cell, a configuration, its refresh stream and a metric are
added with new files and new BENCHMARK.json entries alone."""
import json
import re
import shutil
import time

import numpy as np
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


# A refresh stream that a later configuration could bring as a file alone:
# new orders drawn as dbgen draws them (RF1's inserts), so its rows land all
# over the calendar, and every ``rows_between_deletes`` rows a delete by key
# range of one day, the ship day of a loaded order's last lineitem (found
# through the order sizes that ``make_column`` hands over).
RF1 = '''
import numpy as np


class Stream:

    def __init__(self, config, seed, data):
        self.days = int(config["days"])
        self.every = int(config["rows_between_deletes"])
        self.orderdate_days = int(config["orderdate_days"])
        self.per_order = [int(x) for x in config["lineitems_per_order"]]
        self.offset = [int(x) for x in config["ship_offset_days"]]
        self.rng = np.random.default_rng([int(seed), 7])
        self.keys = np.asarray(data.keys).astype(np.int64)
        ends = np.cumsum(data.order_sizes.astype(np.int64))
        self.last_row = np.minimum(ends, self.keys.size) - 1
        self.loaded_orders = int(np.searchsorted(ends, self.keys.size)) + 1
        self.live = np.bincount(self.keys, minlength=self.days)
        self.ops, self.moves, self.pending = [], [], []

    def _extend(self, k):
        while len(self.ops) <= k:
            if len(self.ops) % (self.every + 1) == self.every:
                j = self.rng.integers(self.loaded_orders)
                day = int(self.keys[self.last_row[j]])
                gone = int(self.live[day])
                self.live[day] = 0
                self.ops.append(("d", day))
                self.moves.append([(day, -gone)])
                continue
            if not self.pending:
                n = self.rng.integers(self.per_order[0],
                                      self.per_order[1] + 1)
                od = self.rng.integers(self.orderdate_days)
                self.pending = (od + self.rng.integers(
                    self.offset[0], self.offset[1] + 1, n)).tolist()
            day = int(self.pending.pop())
            self.live[day] += 1
            self.ops.append(("w", day))
            self.moves.append([(day, 1)])

    def op(self, k):
        self._extend(k)
        return self.ops[k]

    def issue(self, eng, k):
        kind, day = self.op(k)
        if kind == "w":
            eng.write(float(day))
        else:
            eng.delete(float(day), float(day))
        return kind

    def changes(self, k):
        self._extend(k)
        return self.moves[k]

    def newest_day(self, n_ops):
        return self.days - 1

    def ops_for_rows(self, rows):
        return rows + (rows - 1) // self.every if rows > 0 else 0

    def due(self, row_due, first_op):
        out, k = [], first_op
        for t in row_due:
            if self.op(k)[0] == "d":
                out.append(t)
                k += 1
            out.append(t)
            k += 1
        return np.asarray(out, np.float64)
'''
# the same stream with each delete's change one row short
RF1_OFF = RF1.replace("self.moves.append([(day, -gone)])",
                      "self.moves.append([(day, 1 - gone)])")


@pytest.fixture(scope="module")
def rf1_root(tmp_path_factory):
    """The benchmark's checkout with ``streams/test_rf1.py`` and its broken
    twin, each with a configuration, and a mix and a cell for each."""
    root = tmp_path_factory.mktemp("rf1") / "checkout"
    shutil.copytree(pb_registry.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    base = bench["configs"][0]
    (root / "portbench" / "traffic" / "rf1.json").write_text(json.dumps(
        {"reads": {"loop": "open", "rate_qps": 300, "widths": [1, 30, 90, 365],
                   "recent_share": 0.0, "top_k": 0},
         "writes": {"rate_rows_per_s": 300}}))
    for name, src in (("test_rf1", RF1), ("test_rf1_off", RF1_OFF)):
        (root / "portbench" / "streams" / f"{name}.py").write_text(src)
        cfg = json.loads((pb_registry.ROOT / base["file"]).read_text())
        cfg.update(name=name, refresh_stream=name, rows_between_deletes=40)
        (root / "portbench" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append(dict(base, name=name,
                                     file=f"portbench/configs/{name}.json"))
        bench["workloads"].append({"name": name.replace("_", "."),
                                   "config": name, "traffic": "rf1",
                                   "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_a_refresh_stream_added_as_a_file(run_tiny, rf1_root, monkeypatch):
    harness = {p.name: p.read_bytes()
               for p in (pb_registry.ROOT / "portbench").glob("*.py")}
    assert harness == {p.name: p.read_bytes()
                       for p in (rf1_root / "portbench").glob("*.py")}
    seen = []
    orig = pb_harness.Driver.apply_op

    def apply_op(self):
        kind, a, b = orig(self)
        seen.append(self.stream.op(self.n_ops - 1))
        return kind, a, b
    monkeypatch.setattr(pb_harness.Driver, "apply_op", apply_op)
    out = run_tiny("test.rf1", root=rf1_root)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    deletes = [day for kind, day in seen if kind == "d"]
    writes = np.asarray([day for kind, day in seen if kind == "w"])
    assert len(deletes) >= 10 and writes.size >= 400
    # the rows land over the whole calendar, not on a newest day
    assert writes.min() < 300 and writes.max() > 2200


def test_a_stream_with_its_changes_off_by_one_is_not_correct(run_tiny,
                                                             rf1_root):
    out = run_tiny("test.rf1.off", root=rf1_root)
    assert not out["correct"]
    assert out["checks"]["wrong_counts"]["value"] > 0


def test_a_missing_stream_is_named_by_its_path(tmp_path):
    path = tmp_path / "portbench" / "streams" / "no_such.py"
    with pytest.raises(FileNotFoundError, match=re.escape(str(path))):
        pb_registry.load_stream({"refresh_stream": "no_such", "days": 10},
                                1, None, tmp_path)
    assert pb_registry.load_stream({"days": 10}, 1, None).newest_day(5) == 9
