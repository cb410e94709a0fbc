"""Finds a cell's configuration, traffic mix and metric readers by name.

Everything that belongs to one configuration, one traffic mix or one metric
sits in a file of its own, found through ``BENCHMARK.json``:

  BENCHMARK.json                      cells, configurations, metrics, bounds
  <config entry's "file">             a deployment (under portbench/configs/)
  portbench/traffic/<traffic>.json    a traffic mix, read by ``pb_traffic``
  portbench/metrics/<metric>.py       one reader per metric:
                                      ``read(run) -> float | None``
  portbench/streams/<stream>.py       a refresh stream, named by a
                                      configuration's ``refresh_stream``

So a cell, a configuration, its writes or a metric is added by adding files
and ``BENCHMARK.json`` entries; no file of the harness changes.

A configuration may hold ``"engine"``: further ``QueryEngine`` keyword
arguments (``mode``, ``wal_sync``, ``snapshot_on_drain``, ``snapshot_mode``,
``background_save``, ``compact_every``, ``snapshot_keep``, ...), with
``"storage_dir": true`` for a durable engine in a directory the harness
gives each run and judges after a recovery (``pb_harness.engine_kwargs``;
``batch``, ``top_k``, ``drain_policy``, ``drain_units`` and ``writer`` are
the harness's and refused there).

A stream module defines ``Stream(config, seed, data)`` (``data``: the
``pb_data.Data`` made for the run), whose answers depend on ``k`` or
``n_ops`` alone:

  op(k)                 the k-th operation, a tuple whose first item is its
                        kind, "w" (a write) or "d" (a delete)
  issue(eng, k) -> kind issues operation k to the engine (the only place a
                        stream touches the program, through the methods of
                        the object it is handed; it imports nothing of it)
  changes(k)            [(day, signed rows), ...]: how operation k moves the
                        live rows of each day, for the reference
  newest_day(n_ops)     the newest day after the first n_ops operations,
                        where the queries are placed
  ops_for_rows(r)       the operations up to and including the r-th row
                        written, for the warm-up
  due(row_due, k0)      the due times of the operations from k0 on, given
                        the Poisson arrivals ``row_due`` of its rows
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


def _load(kind: str, name: str, root: Path):
    path = Path(root) / "portbench" / f"{kind}s" / f"{name}.py"
    mod_name = f"pb_{kind}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {kind} {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metric: str, root: Path = ROOT):
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    return _load("metric", metric, root).read


class NoStream:
    """A configuration without ``refresh_stream``: no operations, and the
    loaded calendar's last day stays the newest."""

    def __init__(self, config: dict):
        self.days = int(config["days"])

    def newest_day(self, n_ops: int) -> int:
        return self.days - 1


def load_stream(config: dict, seed: int, data, root: Path = ROOT):
    """The configuration's refresh stream: ``Stream(config, seed, data)`` of
    ``portbench/streams/<refresh_stream>.py``, or ``NoStream``."""
    name = config.get("refresh_stream")
    if name is None:
        return NoStream(config)
    return _load("stream", name, root).Stream(config, seed, data)
