"""Print the per-kernel roofline table for a ``BENCH_*.json`` trajectory
(port of ``repro.roofline.report``).

Reads the ``kernels`` suite rows (each carries its analytic ``bytes``/``ops``
derived fields, as ``benchmarks/bench_kernels.py`` writes them) and restates
them against a hardware-table row: by default the card's measured copy rate
(``cuda_stream``), or any other with ``--hardware`` (``h100_sxm``, the
published peaks; ``cpu_stream``, this host's measured STREAM copy):

  PYTHONPATH=src python -m repro_torch.roofline.report BENCH_2026-08-09_pr9_quick.json
  PYTHONPATH=src python -m repro_torch.roofline.report BENCH.json --hardware cpu_stream
"""
from __future__ import annotations

import argparse
import json

from repro_torch.roofline.analysis import hardware, roofline_from_traffic


def kernel_rows(doc: dict) -> list[dict]:
    """The kernels-suite rows of a trajectory document that carry the
    analytic traffic fields (bytes + ops) a roofline needs."""
    rows = doc.get("suites", {}).get("kernels", [])
    return [r for r in rows
            if {"bytes", "ops"} <= set(r.get("derived", {}))]


def build_table(doc: dict, hw_name: str | None = None) -> str:
    hw = hardware(hw_name)
    lines = [
        f"roofline vs {hw.name}: {hw.mem_bw / 1e9:.0f} GB/s mem, "
        f"{hw.vector_ops / 1e9:.0f} Gops/s vector ({hw.note})",
        f"{'kernel row':<34} {'us':>10} {'GB':>8} {'GB/s':>8} "
        f"{'roof us':>9} {'frac':>6}  bound",
    ]
    for row in kernel_rows(doc):
        d = row["derived"]
        us = row["us_per_call"]
        rl = roofline_from_traffic(d["bytes"], d["ops"], us / 1e6, hw)
        lines.append(
            f"{row['name']:<34} {us:>10.1f} {rl['bytes'] / 1e9:>8.4f} "
            f"{rl['achieved_gbps']:>8.1f} {rl['roofline_us']:>9.1f} "
            f"{rl['roofline_frac']:>6.2f}  {rl['bound']}")
    if len(lines) == 2:
        lines.append("  (no kernels-suite rows with bytes/ops fields — "
                     "rerun benchmarks.run with the kernels suite)")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("bench_json", help="BENCH_*.json trajectory file")
    ap.add_argument("--hardware", default=None,
                    choices=("h100_sxm", "cuda_stream", "cpu_stream"),
                    help="hardware-table row to restate against "
                         "(default: the card's measured cuda_stream)")
    args = ap.parse_args(argv)
    with open(args.bench_json) as f:
        doc = json.load(f)
    print(build_table(doc, args.hardware))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
