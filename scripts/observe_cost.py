#!/usr/bin/env python3
"""What the port's observability costs a benchmark cell's rounds.

    python3 scripts/observe_cost.py --workload yi6b-fl-fedrank --seed 12345 \
        --seconds 15 [--checkout DIR] [--out FILE]

Builds the cell's server and policy as ``perfbench`` does (weights and
federation drawn from the seed, the vmapped executor), drives the cell's
checked rounds as warm-up, then times four closed-loop windows of
``--seconds`` each with ``FLConfig.observe`` off, on, on and off: "on" is an
in-memory ``RunRecorder`` registered as the active profiler, which is what
``observe=True`` makes; no ``torch.profiler`` runs.  Prints one JSON line:
``round_s`` (window over rounds) of each window, the medians of each
setting, the spans a round records with each path's mean ms a round on
the host's clock and the card's (the observed windows, no profiler), the
host µs of one span and of the no-op span, the card (name, power limit) and the host (CPU model, cores).

``--checkout`` runs another checkout's program and harness (its ``src`` and
``perfbench``), so one script compares two commits on one card.  Needs a
CUDA device; ``--device cpu --smoke`` runs the cell at the CPU tests' size.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host() -> dict:
    model = platform.processor()
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                model = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    return {"cpu": model, "cores": os.cpu_count()}


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "none"


def cell_args(doc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--checkout", default=str(ROOT))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out")
    return ap


def warm_cell(args):
    """(server, policy, sync) of the cell in ``args.checkout``, built as
    ``perfbench`` builds it and past its checked rounds; None without the
    device asked for."""
    checkout = Path(args.checkout).resolve()
    sys.path[:0] = [str(checkout / "src"), str(checkout)]
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(checkout / "build" / "torch_extensions"))
    import torch

    from perfbench import bench
    from perfbench.traffic import generator
    from perfbench.weights import model_weights, qnet_weights

    if args.device == "cuda" and not torch.cuda.is_available():
        return None
    if args.smoke:
        from perfbench.smoke import smoke_spec
        _, conf, mix = smoke_spec(args.workload)
    else:
        _, conf, mix = bench.load_cell(args.workload)
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    fed = generator.make_federation(mix, conf["vocab_size"], args.seed, dev)
    srv, policy = bench.build_program(conf, mix, fed, model_weights(conf, args.seed, dev),
                                      qnet_weights(args.seed, dev), args.seed, dev)
    for _ in range(mix["check_rounds"]):
        srv.run_round(policy)
    sync()
    return srv, policy, sync


def span_cost(recorder, sync, n: int = 20000) -> dict:
    """Host µs of one empty span of ``recorder()`` (with its device events
    where CUDA is in use), of the flush that resolves them, and of the
    shared no-op span that ``profiling.span`` gives with no recorder active."""
    from repro_torch.obs import profiling

    rec = recorder()
    sync()
    t0 = time.perf_counter()
    for _ in range(n):
        with rec.span("x"):
            pass
    t1 = time.perf_counter()
    rec.flush_round(round=0, mode="sync", host_time_s=0.0)
    t2 = time.perf_counter()
    for _ in range(n):
        with profiling.span("x"):
            pass
    t3 = time.perf_counter()
    return {"span_us": 1e6 * (t1 - t0) / n, "flush_us_per_span": 1e6 * (t2 - t1) / n,
            "null_span_us": 1e6 * (t3 - t2) / n}


def emit(out: dict, path) -> None:
    line = json.dumps(out)
    if path:
        with open(path, "a") as fh:
            fh.write(line + "\n")
    print(line, flush=True)


def main(argv=None) -> int:
    ap = cell_args(__doc__)
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    built = warm_cell(args)
    if built is None:
        print("observe_cost: no CUDA device", file=sys.stderr)
        return 3
    srv, policy, sync = built
    from repro_torch.obs import NULL_RECORDER, RunRecorder, clear_profiler, set_profiler

    windows, spans = [], []
    for on in (False, True, True, False):
        if on:
            srv.obs = RunRecorder()
            set_profiler(srv.obs)
            spans.append(srv.obs)
        else:
            srv.obs = NULL_RECORDER
            clear_profiler()
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            srv.run_round(policy)
            n += 1
        sync()
        windows.append({"observe": on, "rounds": n,
                        "round_s": (time.perf_counter() - t0) / n})
    clear_profiler()
    off = statistics.median(w["round_s"] for w in windows if not w["observe"])
    on = statistics.median(w["round_s"] for w in windows if w["observe"])
    rounds = [r for rec in spans for r in rec.records if r.get("type") == "round"]
    by_path = {}
    for r in rounds:
        for sp in r["spans"]:
            row = by_path.setdefault(sp["span"], [0.0, 0.0])
            row[0] += 1e3 * sp["wall_s"] / len(rounds)
            row[1] += 1e3 * sp.get("device_s", 0.0) / len(rounds)
    emit({"workload": args.workload, "seed": args.seed, "checkout": args.checkout,
          "windows": windows, "round_s_off": off, "round_s_on": on,
          "cost_share": on / off - 1.0,
          "spans_per_round": sum(len(r["spans"]) for r in rounds) / max(len(rounds), 1),
          "span_ms": {k: {"wall": w, "device": d} for k, (w, d) in by_path.items()},
          **span_cost(RunRecorder, sync), "card": card(), "host": host()}, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
