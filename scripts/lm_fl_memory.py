#!/usr/bin/env python3
"""Which allocations make a vmapped LM FL round's peak device memory.

    python3 scripts/lm_fl_memory.py [--layers 4] [--seq 512] [--out FILE]

One ``fedavg`` round of Yi-6B at its published width (bf16, weights from a
seed, depth cut to ``--layers``) as the FL global model under the vmapped
executor, on the card, in the configuration of ``chip_smoke.py``'s
``lm_fl_remat`` check (8 devices, k=4, l_ep=1, local batch 8), once with
``remat=True`` and once with ``remat=False``.  Each round runs with the
CUDA caching allocator's history on; the script replays the recorded
allocations and frees to the round's peak and prints, for each remat
setting, the peak, the bytes live at it grouped by the innermost
``repro_torch`` frame that allocated them (``(no Python frame)``: the
autograd engine's own threads) and by size, and the allocation that set
the peak.  The whole breakdown goes to ``--out`` as JSON.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def frame_of(event) -> str:
    """The innermost ``repro_torch`` frame of an allocation's Python stack."""
    for f in event.get("frames", []):
        name = f["filename"]
        if "repro_torch" in name:
            return f"{name.split('src/')[-1]}:{f['line']} {f['name']}"
    return "(no Python frame)"


def peak_breakdown(trace, top=25) -> dict:
    """Replay the allocator's events: the largest live total, the blocks
    live at that moment grouped by frame and by (frame, size), and the
    frames of the allocation that reached it."""
    live, total, peak, at_peak, peak_event = {}, 0, 0, {}, None
    for ev in trace:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if total > peak:
                peak, at_peak, peak_event = total, dict(live), ev
        elif ev["action"] == "free_requested" and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
    by_frame, by_size = collections.Counter(), collections.Counter()
    for ev in at_peak.values():
        by_frame[frame_of(ev)] += ev["size"]
        by_size[(frame_of(ev), ev["size"])] += 1
    return {
        "peak_gb": peak / 1e9,
        "by_frame_gb": {k: v / 1e9 for k, v in by_frame.most_common(top)},
        "by_frame_and_size": [dict(frame=f, gb_each=s / 1e9, count=n)
                              for (f, s), n in sorted(by_size.items(),
                                                      key=lambda kv: -kv[0][1] * kv[1])[:top]],
        "peak_set_by": [f"{f['filename'].split('/')[-1]}:{f['line']} {f['name']}"
                        for f in (peak_event or {}).get("frames", [])[:12]],
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "lm_fl_memory.json"))
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import LM_FL_REMAT, card_line, layer_saved_bytes, lm_fl_data
    from repro_torch.configs import get_model_config
    from repro_torch.fl import FLConfig, FLServer, LMTask, build_policy

    if not torch.cuda.is_available():
        raise SystemExit("lm_fl_memory: needs a CUDA card")
    c = dict(LM_FL_REMAT, layers=args.layers, seq=args.seq)
    base = dataclasses.replace(get_model_config(c["arch"]), n_layers=c["layers"])
    data = lm_fl_data(base.vocab_size, c["n_devices"], c["seqs_per_device"], c["seq"],
                      c["test_seqs"])
    out = {"card": card_line(), "config": dict(c),
           "params": base.param_count(),
           "saved_bytes_one_layer_predicted": layer_saved_bytes(base, c["batch"], c["seq"])}
    init = None
    for remat in (True, False):
        cfg = dataclasses.replace(base, remat=remat)
        fl = FLConfig(n_devices=c["n_devices"], k_select=c["k"], rounds=1, l_ep=c["l_ep"],
                      local_batch=c["batch"], lr=c["lr"], seed=0, executor="vmapped")
        srv = FLServer(fl, LMTask(cfg, seq_len=c["seq"]), data, device="cuda")
        if init is None:
            init = srv.global_params
        srv.global_params = init
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(max_entries=2_000_000, stacks="python")
        res = srv.run_round(build_policy("fedavg"))
        torch.cuda.synchronize()
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        row = peak_breakdown(snap["device_traces"][0])
        row.update(cohort=res.selected.tolist(), host_s=res.host_time_s,
                   held_gb=held / 1e9,
                   max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9)
        out[f"remat_{'on' if remat else 'off'}"] = row
        print(json.dumps({"remat": remat, **{k: row[k] for k in
                                             ("peak_gb", "held_gb", "max_memory_allocated_gb",
                                              "host_s", "by_frame_gb", "peak_set_by")}}),
              flush=True)
        del srv, snap
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(out["card"], flush=True)


if __name__ == "__main__":
    main()
