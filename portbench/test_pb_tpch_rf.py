"""TPC-H's refresh pairs (``streams/tpch_rf.py``) and the cell that runs them,
``dbgen.refresh``, on the CPU at a tiny size.

- Operations alternate: RF1's next new order, then RF2's next loaded order.
- Each delete names one loaded order's load positions, contiguous, in
  orderkey order from the first, and no order twice.
- ``changes`` moves each order's days by its size, as ``issue`` sends it.
- An order comes due with its first row.
- ``dbgen.refresh`` runs correct with both kinds of operation and a vacuum
  in its window, and reports ``refresh_ack_ms`` over all of them; a twin
  stream with one delete's change off by one does not run correct.
"""
import json
import shutil

import numpy as np
import pytest

import pb_data
import pb_harness
import pb_registry

SEED = 2718281828459


@pytest.fixture(scope="module")
def cfg():
    cell = pb_registry.find_cell("dbgen.refresh")
    return dict(cell.config, rows=12000)


@pytest.fixture(scope="module")
def data(cfg):
    return pb_data.make_column(cfg, SEED, "cpu")


@pytest.fixture
def stream(cfg, data):
    return pb_registry.load_stream(cfg, SEED, data)


class Recorder:
    """An engine that logs what the stream sends it."""

    def __init__(self):
        self.calls = []

    def write(self, v):
        self.calls.append(("w", v))

    def delete_rows(self, ids):
        self.calls.append(("d", np.asarray(ids)))


def _issue(stream, k: int) -> list:
    eng = Recorder()
    assert stream.issue(eng, k) == stream.op(k)[0]
    return eng.calls


def test_operations_alternate_new_and_loaded_orders(stream):
    kinds = [stream.op(k)[0] for k in range(400)]
    assert kinds == ["w", "d"] * 200
    for k in range(0, 40):
        calls = _issue(stream, k)
        assert {c[0] for c in calls} == {kinds[k]}
        assert len(calls) == (stream.rows(k) if kinds[k] == "w" else 1)


def test_each_delete_takes_one_loaded_orders_load_positions(stream, data):
    sizes = data.order_sizes.astype(np.int64)
    end = 0
    seen = set()
    for i in range(300):
        [(kind, ids)] = _issue(stream, 2 * i + 1)
        assert kind == "d" and ids.dtype == np.int64
        assert ids[0] == end and np.array_equal(ids, end + np.arange(sizes[i]))
        assert not seen & set(ids.tolist())
        seen |= set(ids.tolist())
        end += sizes[i]
    # the last loaded order may be cut at the table's end; none lies past it
    last = stream.loaded_orders - 1
    a, b = stream.loaded_rows(last)
    assert a < data.keys.size == b
    with pytest.raises(IndexError, match="deleted all"):
        stream.loaded_rows(last + 1)


def test_changes_move_each_orders_days_by_its_size(stream, data, cfg):
    new_days = []
    for k in range(600):
        moves = stream.changes(k)
        calls = _issue(stream, k)
        if k % 2 == 0:
            assert sum(r for _, r in moves) == stream.rows(k) == len(calls)
            assert [d for d, _ in moves] == [int(v) for _, v in calls]
            new_days += [d for d, _ in moves]
        else:
            ids = calls[0][1]
            assert sum(r for _, r in moves) == -stream.rows(k) == -ids.size
            assert [d for d, _ in moves] == data.keys[ids].astype(
                int).tolist()
        assert 1 <= stream.rows(k) <= 7
    # RF1's orders are dbgen's: days over the whole calendar, inside it
    new_days = np.asarray(new_days)
    assert new_days.min() < 300 and new_days.max() > 2200
    assert new_days.max() < cfg["days"] == stream.newest_day(10**6) + 1


def test_an_order_comes_due_with_its_first_row(stream):
    row_due = np.arange(1000, dtype=np.float64) / 100.0
    for first in (0, 7):
        due = stream.due(row_due, first)
        rows = np.asarray([stream.rows(first + j) for j in range(due.size)])
        starts = np.concatenate([[0], np.cumsum(rows)[:-1]])
        assert np.array_equal(due, row_due[starts])
        assert starts[-1] < 1000 <= starts[-1] + rows[-1]
    total = np.cumsum([stream.rows(k) for k in range(300)])
    for r in (1, 2, 512, 513, int(total[100])):
        n = stream.ops_for_rows(r)
        assert total[n - 1] >= r and (n == 1 or total[n - 2] < r)
    assert stream.ops_for_rows(0) == 0


def test_the_stream_keeps_to_its_deployment(cfg, data):
    with pytest.raises(ValueError, match="layout 'daily'"):
        pb_registry.load_stream(dict(cfg, layout="daily"), SEED, data)
    with pytest.raises(ValueError, match="clause 2.5"):
        pb_registry.load_stream(dict(cfg, orders_per_refresh=1500), SEED,
                                data)
    a = pb_registry.load_stream(cfg, SEED, data)
    b = pb_registry.load_stream(cfg, SEED, data)
    c = pb_registry.load_stream(cfg, SEED + 1, data)
    days = [a.changes(k) for k in range(0, 200, 2)]
    assert days == [b.changes(k) for k in range(0, 200, 2)]
    assert days != [c.changes(k) for k in range(0, 200, 2)]


def test_dbgen_refresh_runs_correct_on_the_cpu(run_tiny, monkeypatch):
    windows, kinds = [], []
    report = pb_harness._report_window
    monkeypatch.setattr(pb_harness, "_report_window",
                        lambda rec, drv, log: (windows.append(rec),
                                               report(rec, drv, log)))
    apply_op = pb_harness.Driver.apply_op

    def logged(self):
        kind, a, b = apply_op(self)
        kinds.append(kind)
        return kind, a, b
    monkeypatch.setattr(pb_harness.Driver, "apply_op", logged)
    # two seconds: the first batch on a loaded CPU may take most of one
    out = run_tiny("dbgen.refresh", seconds=2.0)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    [rec] = windows
    n = rec["ops_in_window"]
    in_window = kinds[len(kinds) - n:]
    assert in_window.count("w") >= 3 and in_window.count("d") >= 3, \
        (n, rec["window_s"], len(rec["backlog"]))
    w = rec["writer"]
    assert w["vacuums"] >= 1 and w["rows_deleted"] > 0 and w["staged"] > 0
    assert len(rec["delete_ms"]) == in_window.count("d")
    # every operation due in the window, RF1 orders and RF2 deletes, from
    # its due time to its acknowledgement, at least as long as the call
    acks = np.asarray(rec["write_ms"])
    calls = np.concatenate([np.asarray(rec["stage_us"]) / 1e3,
                            rec["delete_ms"]])
    assert acks.size == calls.size == n
    assert acks.mean() >= calls.mean()
    assert out["metrics"]["refresh_ack_ms"]["value"] == pytest.approx(
        acks.mean())
    assert "lost_on_recovery" not in out["checks"]


# the stream with its first delete's change one row short
OFF_BY_ONE = '''

_Stream = Stream


class Stream(_Stream):
    def changes(self, k):
        out = super().changes(k)
        return out[1:] if k == 1 else out
'''


def test_a_twin_stream_with_one_delete_off_by_one_is_not_correct(
        run_tiny, tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(pb_registry.ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    streams = root / "portbench" / "streams"
    (streams / "tpch_rf_off.py").write_text(
        (streams / "tpch_rf.py").read_text() + OFF_BY_ONE)
    bench = pb_registry.load_benchmark()
    base = next(c for c in bench["configs"]
                if c["name"] == "tpch_sf10_shipdate_rf")
    cfg = json.loads((pb_registry.ROOT / base["file"]).read_text())
    cfg.update(name="rf_off", refresh_stream="tpch_rf_off")
    (root / "portbench" / "configs" / "rf_off.json").write_text(
        json.dumps(cfg))
    bench["configs"].append(dict(base, name="rf_off",
                                 file="portbench/configs/rf_off.json"))
    bench["workloads"].append({"name": "dbgen.refresh.off",
                               "config": "rf_off", "traffic": "rf_pairs",
                               "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_tiny("dbgen.refresh.off", root=root)
    assert not out["correct"]
    assert out["checks"]["wrong_counts"]["value"] > 0
