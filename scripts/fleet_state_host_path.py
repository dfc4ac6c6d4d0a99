#!/usr/bin/env python3
"""Where the host time of one ``fleet_state`` lookup goes, on one CUDA card.

    python3 scripts/fleet_state_host_path.py [LABEL=ROOT ...]

Each argument names a checkout of this repository (default: this one, as
``current``); each is measured in a process of its own, with ``ROOT/src``
first on the path, in the order given (``parent=A change=. change2=.
parent2=A`` alternates two trees).  At the smoke fleet's lookup (1000
devices resampled from the shipped synthetic week, seed 1, at 5 h) it times
with ``time.perf_counter`` over 1000 calls each, after 100 of warm-up:

* ``empty_ctypes``: a call of the library's launch entry with the same
  number of arguments that returns at its first check (no CUDA call);
* ``wrapper``: ``segment_index_cuda`` on queries already on the card
  (enqueue time; one synchronise after the 1000 calls, counted);
* the steps of the reference's host path, the same in every tree: the
  period wrap and split in numpy, three pageable uploads
  (``torch.as_tensor(..., device=)``), one ``.cpu()`` download (which
  synchronises);
* ``op``: ``ops.segment_index``, host included: the call the trace layer
  makes every round;
* ``torch_searchsorted``: one ``torch.searchsorted`` over the f64 key on the
  card (enqueue time, as ``wrapper``), and ``torch_searchsorted_op`` the
  same with the query key's upload and the result's download;
* ``numpy_searchsorted``: the reference's host path, ``np.searchsorted``
  over the f64 key ``dev * period + t`` on the host.

Prints one JSON line per tree (microseconds per call), then the card's name
and power limit.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CALLS, WARMUP, N = 1000, 100, 1000


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


def measure(label: str) -> dict:
    """Runs inside the tree's own process."""
    import numpy as np
    import torch

    from repro_torch.fl.traces import SyntheticTraceSpec, synthesize_trace
    from repro_torch.kernels.fleet_state import kernel as fk
    from repro_torch.kernels.fleet_state import ops

    dev = torch.device("cuda")
    sync = torch.cuda.synchronize
    tr = synthesize_trace(SyntheticTraceSpec(n_devices=32, days=7, seed=11))
    fleet = tr.resample(N, seed=1, device=dev)
    t = 5 * 3600.0 + fleet.phase_s
    segs = tr.resident(dev)
    lib = fk.LIBRARY.load()
    launch = lib.segment_index_launch
    zeros = [0] * len(launch.argtypes)
    out = {"label": label, "n": N, "s": tr.n_segments, "calls": CALLS}
    out["empty_ctypes"] = per_call_us(lambda: launch(*zeros))

    tau = t % tr.period_s
    qi, qf = ops._split_times(tau)
    src32 = fleet.src.astype(np.int32)
    if hasattr(ops, "pack_queries"):                    # one packed record per query
        q = torch.as_tensor(ops.pack_queries(src32, qi, qf), device=dev)
        wrapper = lambda: fk.segment_index_cuda(segs, q)
    else:                       # a tree from before the packed records: three arrays
        args = [torch.as_tensor(a, device=dev) for a in (src32, qi, qf)]
        wrapper = lambda: fk.segment_index_cuda(segs, *args)
    want = ops.segment_index(segs, tr.period_s, fleet.src, t)
    out["wrapper"] = per_call_us(wrapper, sync)
    out["numpy_wrap_and_split"] = per_call_us(lambda: ops._split_times(
        np.asarray(t, np.float64) % tr.period_s))
    out["upload_x3_pageable"] = per_call_us(lambda: [
        torch.as_tensor(a, device=dev) for a in (src32, qi, qf)], sync)
    res = torch.zeros(N, dtype=torch.int32, device=dev)
    out["download_cpu"] = per_call_us(lambda: res.cpu())
    out["op"] = per_call_us(lambda: ops.segment_index(segs, tr.period_s, fleet.src, t))

    key = tr._seg_dev * tr.period_s + tr.t_start
    qkey = fleet.src * tr.period_s + tau
    key_t, qkey_t = torch.as_tensor(key, device=dev), torch.as_tensor(qkey, device=dev)
    out["torch_searchsorted"] = per_call_us(
        lambda: torch.searchsorted(key_t, qkey_t, right=True), sync)
    out["torch_searchsorted_op"] = per_call_us(lambda: (torch.searchsorted(
        key_t, torch.as_tensor(fleet.src * tr.period_s + t % tr.period_s, device=dev),
        right=True) - 1).cpu().numpy())
    out["numpy_searchsorted"] = per_call_us(lambda: np.searchsorted(
        key, fleet.src * tr.period_s + t % tr.period_s, side="right") - 1)
    got_np = np.searchsorted(key, qkey, side="right") - 1
    out["indices_agree"] = bool(np.array_equal(want, got_np))
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--measure":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("fleet_state_host_path: this script needs a CUDA card")
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fleet_state_host_path: this script needs a CUDA card")
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
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
