"""The benchmark of repro_torch (Hippo on PyTorch and CUDA), one run of one
cell:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. Prints
earlier lines (the card and its power limit, set-up's parts, the
generator's lateness, the backlog), the compared numbers with their limits
as the last lines on standard error, and one JSON result as the last line
of standard output.

    --sweep R1,R2,...   instead of the cell's own read rate, one open-loop
                        window of --seconds per rate, for finding the knee
    --control bf16      judge the reference at bfloat16 in the program's
                        place (it must come out not correct)
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--sweep", default=None)
    ap.add_argument("--control", choices=("bf16",), default=None)
    args = ap.parse_args()

    # every build and kernel cache at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    sys.path[:0] = [str(HERE), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: src/repro_torch is not in this checkout",
              file=sys.stderr)
        return 2
    import pb_checks
    import pb_registry
    cell = pb_registry.find_cell(args.workload, ROOT)

    marks = {"start": T_PROCESS, "python_s": time.perf_counter()}
    import torch
    marks["import_torch_s"] = time.perf_counter()
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    marks["find_cuda_s"] = time.perf_counter()
    import pb_harness
    marks["import_harness_s"] = time.perf_counter()
    sweep = [float(r) for r in args.sweep.split(",")] if args.sweep else None
    out = pb_harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              "cuda", marks, control=args.control,
                              sweep=sweep, log=lambda s: print(s, flush=True))
    found = pb_checks.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the process holds {found}: the program or the "
              f"harness loaded JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
