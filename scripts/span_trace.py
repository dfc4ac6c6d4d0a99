#!/usr/bin/env python3
"""Where a benchmark cell's device time and idle time fall among the port's
spans, from one profiled window.

    python3 scripts/span_trace.py --workload yi6b-fl-fedrank --seed 12345 \
        [--rounds 3] [--out FILE]

Builds the cell's server and policy as ``perfbench`` does, drives its
checked rounds as warm-up, then runs ``--rounds`` rounds with an in-memory
``RunRecorder`` under ``torch.profiler``, so every span is also a profiler
range.  From the trace it prints one JSON line with:

* ``idle_by_span``: the idle time between device operations, split over its
  whole length by the innermost span open on the host at each instant (a
  path such as ``observe/td_steps``), largest first;
* ``top_gaps``: the longest gaps, each with the span open where it began
  (the benchmark's label) and its time by innermost span;
* ``kernels_by_span``: device operation time by the innermost span open when
  the host op that launched it began (kernels the autograd engine's thread
  launches during ``grad`` count there); ``kernel_names_by_span`` the same
  time by operation name, the five largest of each span;
* ``host_ops_of_kernels``: for the eight largest device operations by name,
  their time by the chain of host ops that launched them (the autograd
  node outermost, the op that launched innermost), the five largest chains;
* ``device_s_by_span``: the recorder's own ``device_s`` summed by path over
  the same rounds, to hold against ``kernels_by_span``;
* ``counters``: the round records' counters summed over the same rounds
  (``sgd_update.launches``, ``sgd_update.elements`` and
  ``sgd_update.kernel_elements``: the update's launches and the elements it
  updated by the kernel, against all; in the expert cells ``moe.slots``,
  ``moe.pairs_held`` and ``moe.pairs_kept`` of the evaluation's expert
  layers), and ``moe_slot_fill``, 100 x kept pairs over slots;
* ``mla`` and ``moe`` (each MLA block and expert layer, inside ``grad``
  and ``evaluate``) among the spans of ``device_s_by_span`` and
  ``kernels_by_span``;
* the card (name, power limit).

Needs a CUDA device; ``--device cpu --smoke`` runs the cell at the CPU
tests' size (no device operations, so only the spans are read).
"""
from __future__ import annotations

import sys
import time
from collections import defaultdict

from observe_cost import card, cell_args, emit, warm_cell


def innermost(ranges, t):
    """The path of the ranges open at ``t`` (outermost first), or
    "outside spans"."""
    open_ = [r for r in ranges if r[0] <= t < r[1]]
    if not open_:
        return "outside spans"
    open_.sort(key=lambda r: (r[0], -r[1]))
    return "/".join(r[2] for r in open_)


def split_interval(ranges, a, b):
    """{path: seconds} of [a, b) by the innermost range open at each instant."""
    cuts = sorted({a, b} | {x for r in ranges for x in r[:2] if a < x < b})
    out = defaultdict(float)
    for lo, hi in zip(cuts, cuts[1:]):
        out[innermost(ranges, lo)] += (hi - lo) * 1e-9
    return dict(out)


def op_chains(host_ops) -> dict:
    """{correlation id: "outermost > ... > innermost"} of the host ops
    ``(thread, start, end, name, correlation id)`` nested on one thread:
    the outer two and the inner four, the middle of a longer chain cut to
    "..."."""
    out, stack = {}, []
    for tid, a, b, name, corr in sorted(host_ops, key=lambda o: (o[0], o[1], -o[2])):
        while stack and (stack[-1][0] != tid or stack[-1][1] <= a):
            stack.pop()
        stack.append((tid, b, name))
        names = [n for _, _, n in stack]
        out[corr] = " > ".join(names if len(names) <= 6 else names[:2] + ["..."] + names[-4:])
    return out


def analyse(events) -> dict:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    ranges, ops, kernels, host_ops = [], {}, [], []
    for e in events:
        if e.device_type() == cpu and e.is_user_annotation():
            ranges.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() == cpu and e.linked_correlation_id() == 0:
            ops[e.correlation_id()] = e.start_ns()        # a host op, not a runtime call
            host_ops.append((e.start_thread_id(), e.start_ns(), e.end_ns(), e.name(),
                             e.correlation_id()))
        elif e.device_type() == cuda and not e.is_user_annotation():
            kernels.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.linked_correlation_id(), e.name()))
    busy = []
    for a, b, *_ in sorted(kernels):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    idle = defaultdict(float)
    gaps = []
    for (_, b), (a2, _) in zip(busy, busy[1:]):
        parts = split_interval(ranges, b, a2)
        for k, v in parts.items():
            idle[k] += v
        gaps.append({"s": (a2 - b) * 1e-9, "label": innermost(ranges, b).rsplit("/", 1)[-1],
                     "by_span": dict(sorted(parts.items(), key=lambda kv: -kv[1])[:4])})
    gaps.sort(key=lambda g: -g["s"])
    by_span = defaultdict(float)
    by_name = defaultdict(lambda: defaultdict(float))
    chains = op_chains(host_ops)
    by_op = defaultdict(lambda: defaultdict(float))
    unlinked = 0.0
    for a, b, corr, name in kernels:
        t = ops.get(corr)
        if t is None:
            unlinked += (b - a) * 1e-9
            continue
        path = innermost(ranges, t)
        by_span[path] += (b - a) * 1e-9
        by_name[path][name[:80]] += (b - a) * 1e-9
        by_op[name[:80]][chains[corr]] += (b - a) * 1e-9
    largest = sorted(by_op, key=lambda n: -sum(by_op[n].values()))[:8]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-9,
            "idle_s": sum(idle.values()),
            "idle_by_span": dict(sorted(idle.items(), key=lambda kv: -kv[1])),
            "top_gaps": gaps[:12],
            "kernels_by_span": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
            "kernel_names_by_span": {
                path: dict(sorted(names.items(), key=lambda kv: -kv[1])[:5])
                for path, names in by_name.items()},
            "host_ops_of_kernels": {
                name: dict(sorted(by_op[name].items(), key=lambda kv: -kv[1])[:5])
                for name in largest},
            "kernels_unlinked_s": unlinked}


def main(argv=None) -> int:
    ap = cell_args(__doc__)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    built = warm_cell(args)
    if built is None:
        print("span_trace: no CUDA device", file=sys.stderr)
        return 3
    srv, policy, sync = built
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import RunRecorder, clear_profiler, set_profiler

    srv.obs = RunRecorder()
    set_profiler(srv.obs)
    srv.run_round(policy)                         # the recorder's first round, unprofiled
    srv.obs.records.clear()
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.rounds):
            srv.run_round(policy)
        sync()
        window = time.perf_counter() - t0
    clear_profiler()
    out = analyse(prof.profiler.kineto_results.events())
    dev_s = defaultdict(float)
    wall = defaultdict(float)
    counters = defaultdict(int)
    for r in srv.obs.records:
        for k, v in r.get("metrics", {}).get("counters", {}).items():
            counters[k] += v
        for s in r.get("spans", []):
            dev_s[s["span"]] += s.get("device_s", 0.0)
            wall[s["span"]] += s["wall_s"]
        for k, v in r.get("ops", {}).items():
            wall["op:" + k] += v["wall_s"]
    out.update(workload=args.workload, seed=args.seed, rounds=args.rounds, window_s=window,
               device_s_by_span=dict(sorted(dev_s.items(), key=lambda kv: -kv[1])),
               wall_s_by_span=dict(sorted(wall.items(), key=lambda kv: -kv[1])),
               counters=dict(sorted(counters.items())),
               moe_slot_fill=(100.0 * counters["moe.pairs_kept"] / counters["moe.slots"]
                              if counters.get("moe.slots") else None),
               card=card())
    emit(out, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
