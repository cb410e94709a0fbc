"""The whole run on the CPU with the timed path broken underneath: each
fault a cell can have must make ``correct`` come out false. (The cells run
on one chip, so no exchange between chips can be left out.)"""
import torch
import pytest


def _bad_inspect(orig):
    def inspect(*args):
        out = orig(*args)
        out = out.clone()
        out.view(-1)[0] += 1          # one (shard, query, page) count off
        return out
    return inspect


def test_sound_runs_are_correct(run_tiny):
    assert run_tiny("daily.refresh")["correct"]
    assert run_tiny("dbgen.rowids")["correct"]


def test_writes_returning_the_state_unchanged(run_tiny, monkeypatch):
    from repro_torch.runtime.engine import QueryEngine
    monkeypatch.setattr(QueryEngine, "write", lambda self, value: None)
    out = run_tiny("daily.refresh")
    assert not out["correct"] and out["checks"]["wrong_counts"]["value"] > 0


def test_deletes_returning_the_state_unchanged(run_tiny, monkeypatch):
    from repro_torch.runtime.engine import QueryEngine
    monkeypatch.setattr(QueryEngine, "delete", lambda self, lo, hi: 0)
    out = run_tiny("daily.refresh")
    assert not out["correct"] and out["checks"]["wrong_counts"]["value"] > 0


@pytest.mark.parametrize("cell", ["dbgen.scan", "daily.refresh"])
def test_half_of_each_batch_left_out(run_tiny, monkeypatch, cell):
    from repro_torch.runtime.engine import QueryEngine
    orig = QueryEngine.run_batch
    monkeypatch.setattr(QueryEngine, "run_batch",
                        lambda self: orig(self)[::2])
    out = run_tiny(cell)
    assert not out["correct"]
    assert out["checks"]["missing_answers"]["value"] > 0


@pytest.mark.parametrize("cell", ["dbgen.scan", "daily.scan"])
def test_an_answer_altered_where_it_is_produced(run_tiny, monkeypatch, cell):
    from repro_torch.core import index as hix
    monkeypatch.setattr(hix, "compact_inspect",
                        _bad_inspect(hix.compact_inspect))
    out = run_tiny(cell)
    assert not out["correct"] and out["checks"]["wrong_counts"]["value"] > 0


def test_a_row_id_altered_where_it_is_produced(run_tiny, monkeypatch):
    from repro_torch.core import index as hix
    orig = hix._first_row_ids

    def first_row_ids(*args):
        ids = orig(*args).clone()
        ids[..., 0] = torch.where(ids[..., 0] > 0, ids[..., 0] - 1,
                                  ids[..., 0])
        return ids
    monkeypatch.setattr(hix, "_first_row_ids", first_row_ids)
    out = run_tiny("dbgen.rowids")
    assert not out["correct"]
    assert out["checks"]["wrong_row_ids"]["value"] > 0


def test_the_control_comes_out_not_correct(run_tiny):
    out = run_tiny("dbgen.rowids", control="bf16")
    assert not out["correct"]
    assert out["checks"]["wrong_counts"]["value"] > 0
