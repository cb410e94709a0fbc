"""Finds a cell's configuration, traffic mix and metric readers by name.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found through ``BENCHMARK.json``:

  BENCHMARK.json                      cells, configurations, metrics, bounds
  <config entry's "file">             a deployment (under portbench/configs/)
  portbench/traffic/<traffic>.json    a traffic mix, read by ``pb_traffic``
  portbench/metrics/<metric>.py       one reader per metric:
                                      ``read(run) -> float | None``

So a cell, a configuration or a metric is added by adding files and
``BENCHMARK.json`` entries; no file of the harness changes.
"""
from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file, as run
    traffic: dict         # the traffic mix file
    end_to_end: list      # BENCHMARK.json metric entries this cell reports
    per_layer: list
    root: Path


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def reports(metric: dict, cell: str) -> bool:
    """A metric with a ``workloads`` key is reported in those cells only."""
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    root = Path(root)
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if reports(m, name)],
                root=root)


def load_reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = Path(root) / "portbench" / "metrics" / f"{metric}.py"
    mod_name = "pb_metric_" + re.sub(r"\W", "_", metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
