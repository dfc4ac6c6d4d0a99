"""Run one cell of the port's benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as one JSON object on the last line of standard output,
and each number the check compared beside its limit as the last lines of
standard error.  Needs a CUDA device; exits with another code than 0, and
prints no result, without one, without the benchmark's files, or when JAX
or the JAX package was loaded.
"""
from __future__ import annotations

import os
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def _since_process_start() -> float:
    """Seconds since this process started, from /proc (the interpreter's
    own start-up included), else since this module began."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def _environment() -> None:
    """Every cache of the program inside the checkout, at fixed paths; no
    library loads JAX on its own."""
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if p != here]      # no module of perfbench/ at top level
    for p in (str(CHECKOUT / "src"), str(CHECKOUT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_origin = T_START - _since_process_start()
    if not (CHECKOUT / "BENCHMARK.json").exists() or not (CHECKOUT / "src" / "repro_torch").is_dir():
        print("perfbench: the checkout lacks BENCHMARK.json or src/repro_torch", file=sys.stderr)
        return 2
    _environment()
    import torch

    from perfbench import bench

    benchmark = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
    cell = next((w for w in benchmark["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"perfbench: no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = bench.run(args.workload, args.seed, args.seconds, bool(args.trace), t_origin,
                    benchmark=benchmark)
    banned = bench.forbidden_modules()
    if banned:
        print(f"perfbench: loaded in this process: {', '.join(banned)}", file=sys.stderr)
        return 4
    bench.check.print_table(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
