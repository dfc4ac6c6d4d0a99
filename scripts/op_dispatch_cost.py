#!/usr/bin/env python3
"""Host cost of a call through a dispatcher op, by registration API.

    python3 scripts/op_dispatch_cost.py [--device cpu|cuda] [--calls N]

Defines a do-nothing op with the kernel ops' argument list (three tensors,
a bool, an optional int) twice, through ``torch.library.Library`` (what
``repro_torch.kernels.define_op`` uses) and through
``torch.library.custom_op``, and prints the microseconds a call of each
beside a direct call of the same Python function (each returns a clone of
its first input; the median of 5 runs of N calls).  The difference is what
the dispatcher adds to each kernel call.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional

import torch


def _us(fn, calls):
    for _ in range(calls // 10):
        fn()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append(1e6 * (time.perf_counter() - t0) / calls)
    return statistics.median(runs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--calls", type=int, default=20000)
    args = ap.parse_args()
    key = {"cpu": "CPU", "cuda": "CUDA"}[args.device]

    def kernel(a, b, c, causal, window):
        return a.clone()          # an op's output may not alias an input

    lib = torch.library.Library("dispatch_cost", "FRAGMENT")
    lib.define("lib_op(Tensor a, Tensor b, Tensor c, bool causal, SymInt? window) -> Tensor")
    lib.impl("lib_op", lambda a, b, c, causal, window: kernel(a, b, c, causal, window), key)
    lib_op = torch.ops.dispatch_cost.lib_op.default

    @torch.library.custom_op("dispatch_cost::custom", mutates_args=())
    def custom(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, causal: bool,
               window: Optional[int]) -> torch.Tensor:
        return a.clone()

    x = torch.zeros(4, device=args.device)
    out = {"device": args.device, "torch": torch.__version__, "calls": args.calls}
    for name, fn in (("direct", lambda: kernel(x, x, x, True, None)),
                     ("library_op", lambda: lib_op(x, x, x, True, None)),
                     ("custom_op", lambda: custom(x, x, x, True, None))):
        out[f"{name}_us"] = _us(fn, args.calls)
    with torch.no_grad():
        out["library_op_no_grad_us"] = _us(lambda: lib_op(x, x, x, True, None), args.calls)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
