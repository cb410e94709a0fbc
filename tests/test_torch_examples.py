"""The port's examples (``repro_torch.examples``) against the reference's
(``examples/*.py``), on the CPU.

``quickstart``, ``engine_serving`` and ``hippo_data_pipeline`` print the
reference example's lines once the timing fields are masked: both draw their
data from ``np.random.default_rng(0)``. ``hippokv_longcontext``'s cache goes
through ``repro.core.kvindex`` and through the port: the kept pages are equal
and the kept mass and the relative error agree within 1e-5 at each vote.
``serve_decode`` and ``train_lm`` keep their own asserts and hand the
reference example's argv to the port's CLIs (which
``tests/test_torch_{serve,train}.py`` hold against the reference).
"""
import ast
import gc
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvindex as jkv
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro_torch.core.predicate import Predicate
from repro_torch.examples import (engine_serving, hippo_data_pipeline,
                                  hippokv_longcontext, quickstart,
                                  serve_decode, train_lm)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "src" / "repro_torch" / "examples"
# the timing fields: "19.0 ms", "(10499 q/s)", "speedup 14.1x"
TIMING = re.compile(r"\d+(?:\.\d+)?(?= ms\b| q/s\b|x$)")
# numbers the reference prints at its sizes (semantics, not speed)
REFERENCE_LINES = {
    "quickstart": ["pages=2000  hippo entries=1000",
                   "hippo=65,604 B (rle 117,604)",
                   "hippo: 113 rows, inspected 450/2000 pages",
                   "entries 1000 -> 1002; query still exact: 113 rows",
                   "vacuum re-summarized 105/1002 entries",
                   "pages inspected after vacuum: 262 (was 450)"],
    "engine_serving": ["index: 5 entries, 1,924 B",
                       "15 shard dispatches, 1 pruned",
                       "selected-page ratio 96%",
                       "64 dense fallbacks",
                       "drained 64 rows in 3 units"],
    "hippo_data_pipeline": ["11776/20000 seqs, inspected 232/313 pages",
                            "5120/20000 seqs, inspected 113/313 pages",
                            "2014/20000 seqs, inspected 82/313 pages"],
}
PORTED = {"quickstart": quickstart, "engine_serving": engine_serving,
          "hippo_data_pipeline": hippo_data_pipeline,
          "hippokv_longcontext": hippokv_longcontext,
          "serve_decode": serve_decode, "train_lm": train_lm}
KV_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _light_worker():
    """One torch intra-op thread: the examples are small, and the tests
    that run beside these keep the other cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    jax.clear_caches()
    gc.collect()


def _reference(name: str):
    """``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(f"_reference_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _masked(text: str) -> list[str]:
    return [TIMING.sub("#", line) for line in text.splitlines()]


@pytest.mark.parametrize("name", sorted(REFERENCE_LINES))
def test_example_prints_the_reference_lines(name, capsys):
    assert _reference(name).main() is None
    want = capsys.readouterr().out
    assert PORTED[name].main(["--device", "cpu"]) is None
    got = capsys.readouterr().out
    assert _masked(got) == _masked(want)
    for line in REFERENCE_LINES[name]:
        assert line in got


def test_engine_serving_run_on_a_clustered_day_column(capsys):
    """``run`` as the smoke run drives it at SF10, cut to 20,000 rows:
    sorted days, 1-, 10- and 100-day ranges (some on the appended days),
    64 rows past the last day and a delete of 1% of the domain; every count
    against brute force, and the returned numbers as printed."""
    days = 2555
    rng = np.random.default_rng(8)
    values = np.sort(rng.integers(0, days, 20_000)).astype(np.float32)
    preds = []
    for i in range(60):
        w = (0, 9, 99)[i % 3]
        lo = int(rng.integers(days - 55 if i % 4 == 3 else 0, days + 90 - w))
        preds.append(Predicate.between(float(lo), float(lo + w)))
    new_rows = rng.integers(days, days + 90, 64).astype(np.float32)
    out = engine_serving.run(values, preds, new_rows, (639.0, 664.0),
                             page_card=50, device="cpu")
    printed = capsys.readouterr().out

    def brute(v):
        return np.asarray([int(((v >= p.lo) & (v <= p.hi)).sum())
                           for p in preds])

    kept = values[(values < 639) | (values > 664)]
    np.testing.assert_array_equal(out["counts"], brute(values))
    np.testing.assert_array_equal(out["async_counts"],
                                  brute(np.concatenate([values, new_rows])))
    np.testing.assert_array_equal(out["after_counts"],
                                  brute(np.concatenate([kept, new_rows])))
    assert out["rows"] == 20_000 and out["pages"] == 400
    assert out["sharded"]["shards_pruned"] > 0    # clustered: routing prunes
    assert (f"{out['sharded']['shard_dispatches']} shard dispatches, "
            f"{out['sharded']['shards_pruned']} pruned") in printed
    assert f"{out['compact']['compact_fallbacks']} dense fallbacks" in printed
    assert (f"drained {out['drain']['rows']} rows in "
            f"{out['drain']['units']} units") in printed
    assert out["drain"]["rows"] == 64 and out["drain"]["queue_depth"] == 0


def test_hippokv_matches_the_reference_index():
    keys, values, q = hippokv_longcontext.make_cache(0, "cpu")
    assert tuple(keys.shape) == (1, 4096, 8, 64) and tuple(q.shape) == (1, 8, 64)
    idx, rows = hippokv_longcontext.sweep(keys, values, q)
    jk, jv, jq = (jnp.asarray(t.numpy()) for t in (keys, values, q))
    jidx = jkv.build_kv_index(jkv.KVIndexConfig(
        page_size=64, num_channels=8, resolution=16, keep_buckets=4), jk)
    assert idx.nbytes() == jidx.nbytes()
    ref, _ = jkv.hippo_kv_attention(jq, jk, jv, jnp.ones((1, 8, 64), bool), 64)
    for row in rows:
        mask = jkv.query_page_mask(jidx, jq, min_channels=row["vote"])
        out, mass = jkv.hippo_kv_attention(jq, jk, jv, mask, 64)
        rel = float(jnp.linalg.norm(out - ref) / jnp.linalg.norm(ref))
        np.testing.assert_array_equal(row["mask"].numpy(), np.asarray(mask))
        np.testing.assert_allclose(row["mass"].numpy(), np.asarray(mass),
                                   rtol=0, atol=KV_TOL)
        assert abs(row["rel"] - rel) <= KV_TOL
    # the pages kept shrink as the vote rises, and vote 1 keeps all
    kept = [float(r["mask"].float().mean()) for r in rows]
    assert kept[0] == 1.0 and kept == sorted(kept, reverse=True)


def test_hippokv_main_prints_the_sweep(capsys):
    hippokv_longcontext.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("cache: 4096 positions, 4.0 MiB (bf16); index: ")
    votes = [ln.split() for ln in lines if re.match(r"^\s+[1-5] ", ln)]
    assert [int(v[0]) for v in votes] == [1, 2, 3, 4, 5]
    assert votes[0][1:] == ["100.0%", "1.000", "0.000"]


def _spy(monkeypatch, module, result=None):
    """Record each ``module.main`` argv and what it returned; call the real
    one unless ``result`` (a function of the argv) stands in for it."""
    calls, results = [], []
    real = module.main

    def main(argv=None):
        calls.append(list(argv))
        results.append(real(argv) if result is None else result(argv))
        return results[-1]

    monkeypatch.setattr(module, "main", main)
    return calls, results


def test_serve_decode_hands_the_reference_argv_to_the_cli(monkeypatch, capsys):
    class Done:
        generated = [0] * 24

    ref_calls, _ = _spy(monkeypatch, jserve, lambda argv: [Done()] * 8)
    _reference("serve_decode").main()
    port_calls, finished = _spy(monkeypatch, tserve)
    assert serve_decode.main(["--device", "cpu"]) is None
    out = capsys.readouterr().out
    assert port_calls == [ref_calls[0] + ["--device", "cpu"]]
    assert len(finished[0]) == 8
    assert "served 8 requests / " in out
    assert out.rstrip().endswith("OK: all requests served")


def test_train_lm_hands_the_reference_argv_to_the_cli(monkeypatch, capsys,
                                                      tmp_path):
    ref_calls, _ = _spy(monkeypatch, jtrain, lambda argv: [2.0, 1.0])
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--steps", "30"])
    _reference("train_lm").main()
    port_calls, results = _spy(monkeypatch, ttrain)
    ckpt = tmp_path / "ckpt"
    assert train_lm.main(["--steps", "30", "--ckpt-dir", str(ckpt),
                          "--device", "cpu"]) is None
    out = capsys.readouterr().out
    want = list(ref_calls[0])
    want[want.index("--ckpt-dir") + 1] = str(ckpt)
    assert port_calls == [want + ["--device", "cpu"]]
    losses = results[0]
    assert len(losses) == 30 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert f"OK: loss {losses[0]:.3f} -> {losses[-1]:.3f} over 30 steps" in out


def test_train_lm_default_checkpoint_dir_is_the_ports_own(monkeypatch):
    calls, _ = _spy(monkeypatch, ttrain, lambda argv: [2.0, 1.0])
    train_lm.main(["--steps", "3", "--device", "cpu"])
    ckpt = Path(calls[0][calls[0].index("--ckpt-dir") + 1])
    assert ckpt.name == "repro_torch_example_ckpt"
    assert "repro_example_ckpt" not in str(ckpt)


@pytest.mark.parametrize("name", sorted(PORTED))
def test_example_without_device_needs_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORTED[name].main([])


@pytest.mark.parametrize("name", sorted(p.stem for p in EXAMPLES.glob("*.py")))
def test_example_imports_neither_jax_nor_the_reference(name):
    tree = ast.parse((EXAMPLES / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert roots <= {"argparse", "os", "tempfile", "time", "numpy", "torch",
                     "repro_torch"}, roots
    assert not roots & {"jax", "jaxlib", "repro"}
