"""The benchmark's one command, run from the root of a checkout:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

It needs a CUDA card (it never falls back to the CPU) and prints, as the
last line of standard output, one JSON object: correct, attempted, failed,
metrics (the cell's end-to-end metrics, or with --trace 1 its per-layer
ones), device and, last, checks (each number compared with its limit),
which are also the last lines of standard error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, "build", "bench-cache", _sub)
# one process with few threads: the host's share of a frame steadier
HOST_THREADS = "2"
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = HOST_THREADS


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness

    t0 = time.perf_counter() - harness.process_age_s()
    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    cell = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not cell:
        print(f"no workload named {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    torch.set_num_threads(int(HOST_THREADS))
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell[0]["chips"]):
        print(f"{args.workload} needs {cell[0]['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t0, bench=bench)
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in this process: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
