"""Readings that the check's limits are set from, for one cell.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed, in one process: set-up as in a run (weights, federation,
server, policy, the checked rounds), the reference over the logged rounds
and the numbers the check compares (the program's lower readings); for a
control seed also the fp8 control in the program's place, compared with
the same reference (the upper readings).  No measured window.  One JSON
line a seed on standard output.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seed: int, control: bool, device: str = "cuda", spec=None,
             fault: str = "") -> dict:
    """One seed's numbers for the program (and, with ``control``, for the
    fp8 control), with ``fault`` planted in the program if given."""
    import torch

    from perfbench import bench
    from perfbench.reference import model as ref_model
    from perfbench.traffic import generator
    from perfbench.weights import model_weights, qnet_weights

    wl, conf, mix = spec or bench.load_cell(cell)
    dev = torch.device(device)
    undo = plant(fault) if fault else None
    weights = model_weights(conf, seed, dev)
    q0 = qnet_weights(seed, dev)
    fed = generator.make_federation(mix, conf["vocab_size"], seed, dev)
    srv, policy = bench.build_program(conf, mix, fed, weights, q0, seed, dev)
    prog, log = bench.checked_rounds(srv, policy, mix, weights, q0)
    if undo is not None:
        undo()
    from repro_torch.fl.engine import _bucket_step

    del srv, policy, weights, fed
    _bucket_step.cache_clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers, ref = bench.reference_check(prog, log, conf, mix, seed, dev)
    out = {"cell": cell, "seed": seed, "fault": fault, "program": numbers,
           "reference_s": time.perf_counter() - t0}
    if control:
        out["control"], _ = bench.reference_check(None, log, conf, mix, seed, dev,
                                                  prec=ref_model.CONTROL, ref_rec=ref)
    return out


def plant(fault: str):
    """Break the program's timed path underneath with ``fault``; returns the
    function that mends it.

    * ``state_unchanged``: every client's SGD step returns its params;
    * ``half_batch``: a step's loss over the first half of its rows;
    * ``answer_altered``: the test loss 1% high where it is computed;
    * ``cohort_altered``: ``select_topk`` keeps the worst-scored candidates."""
    import torch

    from repro_torch.core import fedrank
    from repro_torch.fl import client, engine
    from repro_torch.fl.server import FLServer
    from repro_torch.fl.tasks import LMTask

    saved = [(client, "_sgd_stacked", client._sgd_stacked), (LMTask, "loss", LMTask.loss),
             (FLServer, "_evaluate", FLServer._evaluate),
             (fedrank, "select_topk", fedrank.select_topk)]
    if fault == "state_unchanged":
        client._sgd_stacked = lambda lr: (lambda a, g: a)
    elif fault == "half_batch":
        loss = LMTask.loss
        LMTask.loss = lambda self, p, batch: loss(self, p, {
            k: (v[: v.shape[0] // 2] if torch.is_tensor(v) else v) for k, v in batch.items()})
    elif fault == "answer_altered":
        evaluate = FLServer._evaluate

        def off(self):
            acc, loss = evaluate(self)
            return acc, loss * 1.01
        FLServer._evaluate = off
    elif fault == "cohort_altered":
        pick = fedrank.select_topk

        def worst_cut(scores_fn, states, mask, k, **kw):
            idx, vals = pick(scores_fn, states, mask, len(states), **kw)
            return idx[::-1][:k].copy(), vals[::-1][:k].copy()
        fedrank.select_topk = worst_cut
    else:
        raise ValueError(f"unknown fault {fault!r}")
    engine._bucket_step.cache_clear()

    def undo():
        for obj, name, value in saved:
            setattr(obj, name, value)
        engine._bucket_step.cache_clear()
    return undo


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="comma-separated faults to plant, "
                    "each read on every seed (see plant)")
    args = ap.parse_args()
    sys.path[:] = [p for p in sys.path if p != str(ROOT / "perfbench")]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    for fault in [""] + [f for f in args.faults.split(",") if f]:
        for s in seeds:
            print(json.dumps(readings(args.workload, s, s in ctrl and not fault, fault=fault)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
