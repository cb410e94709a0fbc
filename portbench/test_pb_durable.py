"""Engine settings from a configuration's ``"engine"`` object, a storage
directory per run, and the recovery check ``lost_on_recovery``, on the CPU
at a tiny size.

- ``engine_kwargs`` gives the benchmark's three cells the four arguments the
  harness always set, and refuses the keys it owns.
- A durable cell (``daily.durable``: a journal record fsynced per write and
  range delete, a delta per drain; ``daily.journal``: no commit after the
  first snapshot) runs correct, is judged again on an engine recovered from
  its directory, and leaves no directory behind, on failure neither.
- A write or a range delete acknowledged with its journal record dropped
  makes ``correct`` false through ``lost_on_recovery`` alone.
- ``"mode": "dense"`` runs the routed dense engine, correct.
- ``refresh_ack_ms`` is the mean, over every write and delete due in the
  window, of the time from its due time to its acknowledgement.
"""
import os
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest

import pb_data
import pb_harness
import pb_registry
from pb_harness import Run, engine_kwargs

SEED = 987654321987
ACCEPTED = {
    "dbgen.scan": {"batch": 64, "top_k": 0, "drain_policy": "between_batches",
                   "drain_units": 1},
    "dbgen.rowids": {"batch": 64, "top_k": 32,
                     "drain_policy": "between_batches", "drain_units": 1},
    "dbgen.refresh": {"batch": 64, "top_k": 0,
                      "drain_policy": "between_batches", "drain_units": 2},
}


def _run(root, name, tiny, seconds=0.6, log=None):
    cell = tiny(pb_registry.find_cell(name, root))
    return pb_harness.run_cell(cell, SEED, seconds, False, "cpu",
                               time.perf_counter(),
                               log=log or (lambda s: None))


def _own_dirs(root: Path) -> list:
    base = root / ".portbench_cache" / "storage"
    return [p for p in base.glob(f"*.{os.getpid()}")] if base.is_dir() else []


@pytest.mark.parametrize("name", sorted(ACCEPTED))
def test_the_accepted_cells_get_the_four_arguments_they_always_had(name):
    cell = pb_registry.find_cell(name)
    kw = engine_kwargs(cell.config, cell.traffic)
    assert kw == ACCEPTED[name]
    assert [type(v) for v in kw.values()] == [int, int, str, int]
    assert "engine" not in cell.config


def test_the_harness_builds_the_engine_with_those_arguments(run_tiny,
                                                             monkeypatch):
    from repro_torch.runtime.engine import QueryEngine
    seen = []
    init = QueryEngine.__init__

    def spy(self, index, **kw):
        seen.append(kw)
        init(self, index, **kw)
    monkeypatch.setattr(QueryEngine, "__init__", spy)
    out = run_tiny("dbgen.scan", seconds=0.3)
    assert out["correct"] and "lost_on_recovery" not in out["checks"]
    assert seen == [ACCEPTED["dbgen.scan"]]


@pytest.mark.parametrize("engine", [
    {"batch": 32}, {"top_k": 8}, {"drain_policy": "manual"},
    {"drain_units": 4}, {"writer": None}, {"storage_dir": False},
    {"storage_dir": "/elsewhere"}, {"storage_dir": 1},
    {"background_save": True, "storage_dir": True}])
def test_engine_keys_the_harness_owns_are_refused(engine):
    cfg = dict(pb_registry.find_cell("dbgen.scan").config, engine=engine)
    key = next(iter(engine))
    with pytest.raises(ValueError, match=f"'{key}'"):
        engine_kwargs(cfg, {"reads": {"top_k": 0}}, Path("run_dir"))


def test_engine_keys_pass_through_and_storage_gets_the_run_directory():
    cfg = dict(pb_registry.find_cell("dbgen.scan").config,
               engine={"mode": "dense", "storage_dir": True,
                       "wal_sync": False, "snapshot_keep": 2,
                       "background_save": False})
    kw = engine_kwargs(cfg, {"reads": {}}, Path("run_dir"))
    assert kw == dict(ACCEPTED["dbgen.scan"], mode="dense",
                      storage_dir=Path("run_dir"), wal_sync=False,
                      snapshot_keep=2, background_save=False)
    with pytest.raises(ValueError, match="storage directory"):
        engine_kwargs(cfg, {"reads": {}})


@pytest.mark.parametrize("name", ["daily.durable", "daily.journal"])
def test_a_durable_cell_is_judged_again_after_recovery(test_root, tiny,
                                                       monkeypatch, name):
    from repro_torch.checkpointing.wal import Journal
    from repro_torch.runtime.engine import QueryEngine
    appended = {"insert": 0, "delete": 0}
    recovered = []
    for kind in appended:
        orig = getattr(Journal, f"append_{kind}")

        def counted(self, *a, _orig=orig, _kind=kind):
            appended[_kind] += 1
            return _orig(self, *a)
        monkeypatch.setattr(Journal, f"append_{kind}", counted)
    recover = QueryEngine.recover.__func__

    def spy(cls, storage_dir, **kw):
        assert Path(storage_dir).is_dir() and not kw["snapshot_on_recover"]
        recovered.append(Path(storage_dir))
        return recover(cls, storage_dir, **kw)
    monkeypatch.setattr(QueryEngine, "recover", classmethod(spy))
    lines = []
    # two seconds: a drain's commit on a loaded CPU may take most of one
    out = _run(test_root, name, tiny, seconds=2.0, log=lines.append)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert "lost_on_recovery" in out["checks"]
    assert appended["insert"] > 100 and appended["delete"] > 10, appended
    [path] = recovered
    assert path.parent == test_root / ".portbench_cache" / "storage"
    assert path.name == f"{name}.{SEED}.{os.getpid()}"
    assert not path.exists() and not _own_dirs(test_root)
    [line] = [s for s in lines if s.startswith("storage: ")]
    for part in ("wchar", "directory", "persists", "recover_s"):
        assert part in line
    assert out["metrics"]["refresh_ack_ms"]["value"] > 0


def _loaded_days(test_root, tiny) -> np.ndarray:
    cell = tiny(pb_registry.find_cell("daily.journal", test_root))
    keys = pb_data.make_column(cell.config, SEED, "cpu").keys
    return np.bincount(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("kind", ["insert", "delete"])
def test_an_acknowledged_operation_missing_from_the_journal_is_lost(
        test_root, tiny, monkeypatch, kind):
    from repro_torch.checkpointing.wal import Journal
    loaded = _loaded_days(test_root, tiny)
    orig = getattr(Journal, f"append_{kind}")
    dropped = []
    calls = [0]

    def drop_one(self, *a):
        # the 100th write; the first range delete of a day that holds rows
        calls[0] += 1
        due = calls[0] == 100 if kind == "insert" else \
            int(a[0]) < loaded.size and loaded[int(a[0])] > 0
        if due and not dropped:
            dropped.append(a)
            return self.last_seqno
        return orig(self, *a)
    monkeypatch.setattr(Journal, f"append_{kind}", drop_one)
    out = _run(test_root, "daily.journal", tiny)
    assert len(dropped) == 1
    assert not out["correct"]
    assert out["checks"]["lost_on_recovery"]["value"] > 0
    assert out["checks"]["wrong_counts"]["value"] == 0
    assert out["failed"] >= out["checks"]["lost_on_recovery"]["value"]
    assert not _own_dirs(test_root)


def test_the_directory_goes_when_the_run_raises(test_root, tiny,
                                                monkeypatch):
    base = test_root / ".portbench_cache" / "storage"
    base.mkdir(parents=True, exist_ok=True)
    ended = subprocess.Popen(["true"])
    ended.wait()
    leftover = base / f"daily.durable.1.{ended.pid}"
    (leftover / "wal").mkdir(parents=True)
    running = base / f"daily.durable.2.{os.getppid()}"
    running.mkdir(exist_ok=True)
    made = []

    def boom(drv, *a):
        made.extend((d, sorted(f.name for f in d.iterdir()))
                    for d in _own_dirs(test_root))
        raise RuntimeError("a fault in the warm-up")
    monkeypatch.setattr(pb_harness, "_warm_up", boom)
    try:
        with pytest.raises(RuntimeError, match="warm-up"):
            _run(test_root, "daily.durable", tiny)
        [(path, files)] = made
        assert files      # the engine's first snapshot and its journal
        assert not _own_dirs(test_root) and not leftover.exists()
        assert running.is_dir()      # its process still runs
    finally:
        running.rmdir()


def test_the_dense_engine_runs_correct_from_the_configuration(
        test_root, tiny, monkeypatch):
    from repro_torch.runtime.engine import QueryEngine
    modes = []
    run_batch = QueryEngine.run_batch

    def spy(self):
        modes.append(self.mode)
        return run_batch(self)
    monkeypatch.setattr(QueryEngine, "run_batch", spy)
    out = _run(test_root, "dbgen.dense", tiny, seconds=0.3)
    assert out["correct"], out["checks"]
    assert "lost_on_recovery" not in out["checks"]
    assert modes and set(modes) == {"dense"}


def test_the_storage_line_names_the_mount(tmp_path):
    assert pb_harness._fs_type(tmp_path) != "unknown"
    before = pb_harness._io_written()
    (tmp_path / "f").write_bytes(b"x" * 4096)
    assert pb_harness._io_written() - before >= 4096


def _reader():
    return pb_registry.load_reader("refresh_ack_ms")


def test_refresh_ack_ms_is_the_mean_over_writes_and_deletes():
    # due-to-acknowledgement of every operation: not the calls' own spans
    run = Run(setup_s=1.0, write_ms=np.asarray([6.0, 0.5, 12.5, 1.0]),
              stage_us=np.asarray([100.0, 300.0, 500.0]),
              delete_ms=np.asarray([0.2]))
    assert _reader()(run) == pytest.approx(5.0)


@pytest.mark.parametrize("spans", [False, True], ids=["no_op", "spans_only"])
def test_refresh_ack_ms_reads_nothing_without_operations(spans):
    calls = np.asarray([0.3]) if spans else np.asarray([])
    run = Run(setup_s=1.0, write_ms=np.asarray([]), stage_us=calls * 1e3,
              delete_ms=calls)
    assert _reader()(run) is None
