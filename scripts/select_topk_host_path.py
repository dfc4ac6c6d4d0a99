#!/usr/bin/env python3
"""Where the host time of one ``select_topk`` op call goes, on one CUDA card.

    python3 scripts/select_topk_host_path.py [LABEL=ROOT ...]

Each argument names a checkout of this repository (default: this one, as
``current``); each is measured in a process of its own, with ``ROOT/src``
first on the path, in the order given (``parent=A change=. change2=.
parent2=A`` alternates two trees).  At the main path's two calls (the fleet
cut: N=1000 rows, F=6, a 6→64→64→1 Q-net from seed 0, k=20, 30% of rows
masked; the probe-cohort ordering: N=25, k=25, none masked) it times with
``time.perf_counter`` over 1000 calls each, after 100 of warm-up:

* ``empty_ctypes``: a call of the library's launch entry with as many
  arguments that returns at its first check (no CUDA call);
* ``wrapper``: ``select_topk_cuda`` on tensors already on the card
  (enqueue time; one synchronise after the 1000 calls, counted);
* the steps of the sequence the one-call route replaced, the same in every
  tree: six parameter copies (``detach().float().contiguous()``), three
  pageable uploads (``torch.as_tensor(..., device=)``), two ``.cpu()``
  downloads (each synchronises);
* ``old_sequence``: those steps around the device wrapper, as the op made
  them before the one-call route (rebuilt here, so it runs in any tree);
* ``op``: ``ops.select_topk``, host included: the call the policies make.

Prints one JSON line per tree and shape (microseconds per call), then the
card's name and power limit.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS, WARMUP, F, H = 1000, 100, 6, 64
SHAPES = (("main_probe_set", 1000, 20, 0.3), ("main_select", 25, 25, 0.0))


def per_call_us(fn, sync=None):
    for _ in range(WARMUP):
        fn()
    if sync:
        sync()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    if sync:
        sync()
    return 1e6 * (time.perf_counter() - t0) / CALLS


def measure(label: str) -> list:
    """Runs inside the tree's own process."""
    import numpy as np
    import torch

    from repro_torch.kernels.select_topk import kernel as sk
    from repro_torch.kernels.select_topk import ops

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    lib = sk.LIBRARY.load()
    launch = lib.select_topk_launch
    zeros = [0] * len(launch.argtypes)
    rng = np.random.default_rng(0)
    shapes = {"w1": (F, H), "b1": (H,), "w2": (H, H), "b2": (H,), "w3": (H, 1), "b3": (1,)}
    params = {k: torch.as_tensor(rng.normal(size=s) * 0.3, dtype=torch.float32, device=dev)
              for k, s in shapes.items()}
    rows = []
    for shape, n, k, masked in SHAPES:
        states = rng.normal(size=(n, F))
        m = rng.random(n) >= masked
        bias = -0.05 * np.sqrt(rng.integers(0, 5, n).astype(np.float64))
        k_eff = min(k, int(m.sum()))
        out = {"label": label, "shape": shape, "n": n, "k": k, "calls": CALLS}
        out["empty_ctypes"] = per_call_us(lambda: launch(*zeros))
        feats = torch.as_tensor(states, dtype=torch.float32, device=dev)
        mt = torch.as_tensor(m, dtype=torch.float32, device=dev)
        bt = torch.as_tensor(bias, dtype=torch.float32, device=dev)
        out["wrapper"] = per_call_us(lambda: sk.select_topk_cuda(params, feats, mt, bt, k=k),
                                     sync)
        out["param_copies_x6"] = per_call_us(
            lambda: {nm: t.detach().float().contiguous() for nm, t in params.items()})
        out["upload_x3_pageable"] = per_call_us(lambda: (
            torch.as_tensor(np.ascontiguousarray(states, np.float32), device=dev),
            torch.as_tensor(m.astype(np.float32), device=dev),
            torch.as_tensor(np.asarray(bias, np.float32), device=dev)), sync)
        vals, idx = sk.select_topk_cuda(params, feats, mt, bt, k=k)
        out["download_cpu_x2"] = per_call_us(lambda: (idx[:k_eff].cpu(), vals[:k_eff].cpu()))

        def old_sequence():
            p = {nm: t.detach().float().contiguous() for nm, t in params.items()}
            x = torch.as_tensor(np.ascontiguousarray(states, np.float32), device=dev)
            mm = torch.as_tensor(m.astype(np.float32), device=dev)
            bb = torch.as_tensor(np.asarray(bias, np.float32), device=dev)
            v, i = sk.select_topk_cuda(p, x, mm, bb, k=k)
            return (i[:k_eff].cpu().numpy().astype(np.int64),
                    v[:k_eff].cpu().numpy().astype(np.float32))

        def op():
            return ops.select_topk(params, states, m, k, bias=bias)

        out["old_sequence"] = per_call_us(old_sequence)
        out["op"] = per_call_us(op)
        out["agree"] = bool(np.array_equal(op()[0], old_sequence()[0]))
        rows.append(out)
    return rows


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("select_topk_host_path: this script needs a CUDA card")
    if len(argv) == 2 and argv[0] == "--measure":
        for row in measure(argv[1]):
            print(json.dumps(row), flush=True)
        return 0
    trees = [a.split("=", 1) for a in argv] or [["current", str(ROOT)]]
    for label, root in trees:
        root = Path(root).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--measure", label], env=env, cwd=root,
                              capture_output=True, text=True, timeout=600)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"{label}: exit {proc.returncode}")
        for line in proc.stdout.strip().splitlines()[-len(SHAPES):]:
            print(line, flush=True)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
