"""One run of one cell: set-up, the measured window, the traced variant and
the check of the outputs against the reference.

The system under test is ``repro_torch.fl.server.FLServer.run_round`` of the
PyTorch port, driven in a closed loop: one synchronous round after another,
each starting when the last has ended (it ends in a host read of the test
loss).  Set-up draws the weights and the federation from the seed, builds
the server and the policy, and drives the first ``check_rounds`` rounds
through the same call, logging what the reference needs; that same server
and policy then go into the window.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import check, families, flops
from perfbench.reference import fl as ref_fl
from perfbench.reference import model as ref_model
from perfbench.traffic import generator
from perfbench.weights import model_weights, qnet_weights

ROOT = Path(__file__).resolve().parent
PROFILED_ROUNDS = 3


def model_dims(raw: dict, root: Path = ROOT) -> dict:
    """A configuration file's model in the harness's names, by its family:
    ``<root>/families/<family>.py`` where the file names one, which leaves
    that file under ``family`` for the dispatchers
    (:func:`perfbench.families.of`), else the benchmark's ``decoder``."""
    if "family" not in raw:
        return families.load(families.DEFAULT).dims(raw)
    fam = families.load(raw["family"], root)
    return dict(fam.dims(raw), family=fam.__file__)


def load_cell(name: str, root: Path = ROOT):
    """(workload, configuration, traffic mix) of the cell, from its files
    under ``root``: ``workloads/<cell>.json`` names its configuration
    (``configs/<config>.json``) and its mix (``traffic/<mix>.json``)."""
    wl = json.loads((root / "workloads" / f"{name}.json").read_text())
    conf = model_dims(json.loads((root / "configs" / f"{wl['config']}.json").read_text()), root)
    return wl, conf, generator.load_mix(wl["traffic"], root / "traffic")


def port_config(conf: dict):
    """The port's ModelConfig for the configuration file: its registry
    entry with the fields its family sets from the file."""
    from repro_torch.configs import get_model_config

    base = get_model_config(conf["model"])
    return dataclasses.replace(base, **families.of(conf).port_fields(conf, base))


class LoggedPolicy:
    """The cell's policy, with each call's host inputs logged: the fleet
    state and the last losses a FedRank cut reads, and the state of the
    round's random stream before the policy draws from it.  Used for the checked rounds only; the
    window calls the policy itself."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.needs_probing = getattr(inner, "needs_probing", False)
        self.entry: dict = {}

    def probe_set(self, ctx):
        s = ctx.sys
        self.entry["ctx"] = {
            "last_loss": np.asarray(ctx.last_loss, np.float64).copy(),
            "t_comp": s.t_comp.copy(), "t_comm": s.t_comm.copy(),
            "e_comp": s.e_comp.copy(), "e_comm": s.e_comm.copy(),
            "est_t": ctx.est_t_round.copy(), "est_e": ctx.est_e_round.copy(),
            "data_sizes": np.asarray(ctx.data_sizes, np.float64).copy(),
            "available": np.asarray(ctx.available, bool).copy(),
            "selection_count": np.asarray(ctx.selection_count, np.float64).copy()}
        return self.inner.probe_set(ctx)

    def select(self, ctx, probe_ids, probe_states):
        self.entry["rng_select"] = ctx.rng.bit_generator.state
        self.entry["n_online"] = int(np.asarray(ctx.available).sum())
        return self.inner.select(ctx, probe_ids, probe_states)

    def observe(self, ctx, result, probe_ids, probe_states):
        return self.inner.observe(ctx, result, probe_ids, probe_states)


def build_program(conf: dict, mix: dict, fed, weights, q0, seed: int, device,
                  observe=None):
    """The port's server and policy over the benchmark's inputs."""
    from repro_torch.data import FederatedData, SyntheticClassificationDataset
    from repro_torch.fl import FLConfig, FLServer, LMTask, build_policy

    class GivenWeights(LMTask):
        """The LM task starting from the benchmark's weights (handed over
        once: the executor's step cache keeps the task, not the weights)."""

        def init(self, seed=0, device=None):
            w, self.weights = self.weights, None
            return w

    task = GivenWeights(port_config(conf), seq_len=mix["seq_len"])
    task.weights = weights
    data = FederatedData(
        SyntheticClassificationDataset(fed.train_x, fed.train_y, conf["vocab_size"]),
        SyntheticClassificationDataset(fed.test_x, fed.test_y, conf["vocab_size"]),
        [torch.as_tensor(r, device=device) for r in fed.client_rows])
    cfg = FLConfig(n_devices=mix["n_devices"], k_select=mix["k"], l_ep=mix["l_ep"],
                   local_batch=mix["local_batch"], lr=mix["lr"], scenario=mix["scenario"],
                   executor="vmapped", seed=seed, observe=observe)
    srv = FLServer(cfg, task, data, device=device)
    if mix["policy"] == "fedrank":
        policy = build_policy("fedrank", qnet=q0, k=mix["k"], seed=seed,
                              **mix.get("policy_kwargs", {}))
    else:
        policy = build_policy(mix["policy"])
    return srv, policy


def _change(p, p0) -> Dict[str, float]:
    a, b = ref_model.leaves(p), ref_model.leaves(p0)
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(a[n].float() - b[n].float(),
                                                  dtype=torch.float64)) for n in a}


def checked_rounds(srv, policy, mix: dict, weights, q0):
    """Drive the first rounds through ``run_round`` and log them: (the
    program's record for :func:`check.compare`, the host log the reference
    follows)."""
    logged = LoggedPolicy(policy)
    rec = {"rounds": []}
    log = []
    fedrank = mix["policy"] == "fedrank"
    for r in range(mix["check_rounds"]):
        logged.entry = {}
        res = srv.run_round(logged)
        lost = set(res.failed.tolist()) | set(res.stragglers.tolist())
        survivors = [int(i) for i in res.selected if int(i) not in lost]
        trained = res.probe_set if fedrank else np.asarray(survivors, np.int64)
        lg = dict(logged.entry, probe_ids=res.probe_set.copy(), selected=res.selected.copy(),
                  probe_losses=srv.last_loss[res.probe_set].copy(),
                  survivors=survivors, r_t=res.r_t, r_e=res.r_e,
                  t_budget=srv.t_budget, e_budget=srv.e_budget)
        lg.setdefault("n_online", int(res.n_available))
        log.append(lg)
        out = {"client_loss": {int(c): float(srv.last_loss[c]) for c in trained},
               "test_loss": float(res.test_loss), "chosen": res.selected.copy()}
        if fedrank:
            _, m_top = ref_fl.probe_sizes(lg["n_online"], mix["k"], _pf(mix))
            out["probe_top"] = res.probe_set[:m_top]
        rec["rounds"].append(out)
        if r == 0:
            rec["change_first"] = _change(srv.global_params, weights)
    rec["change_last"] = _change(srv.global_params, weights)
    if fedrank:
        rec["qnet_change"] = {n: float((policy.q[n].double() - q0[n].double()).norm())
                              for n in sorted(q0)}
    return rec, log


def _pf(mix: dict) -> float:
    return dict(ref_fl.DEFAULT_FEDRANK, **mix.get("policy_kwargs", {}))["probe_factor"]


def reference_check(prog_rec: dict, log: list, conf: dict, mix: dict, seed: int, device,
                    prec=ref_model.REFERENCE, ref_rec: Optional[dict] = None):
    """Run the reference over the logged rounds (weights and data drawn
    again from the seed) and compare ``prog_rec`` with it: (numbers,
    reference record)."""
    ref_model.no_tf32()
    fed = generator.make_federation(mix, conf["vocab_size"], seed, device)
    if ref_rec is None:
        ref_rec = ref_fl.follow(model_weights(conf, seed, device), qnet_weights(seed, device),
                                fed, log, conf, mix, seed, ref_model.REFERENCE)
    if prec is not ref_model.REFERENCE:
        prog_rec = ref_fl.follow(model_weights(conf, seed, device), qnet_weights(seed, device),
                                 fed, log, conf, mix, seed, prec)
    numbers = check.compare(prog_rec, ref_rec, mix, [lg["n_online"] for lg in log])
    return numbers, ref_rec


# ---------------------------------------------------------------------------
# the traced run
# ---------------------------------------------------------------------------


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def reduce_profile(events, window_s: float) -> dict:
    """Device busy time, time by device op, and the idle gaps labelled by
    the innermost span open when each began, from the profiler's events."""
    dev, spans = [], []
    by_op: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for e in events:
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            a, d = e.start_ns(), e.duration_ns()
            dev.append((a, a + d))
            by_op[e.name()] = by_op.get(e.name(), 0.0) + d * 1e-9
            counts[e.name()] = counts.get(e.name(), 0) + 1
        elif e.is_user_annotation() and e.device_type() == torch.autograd.DeviceType.CPU:
            spans.append((e.start_ns(), e.end_ns(), e.name()))
    busy = _union(dev)
    gaps = []
    for (_, b), (a2, _) in zip(busy, busy[1:]):
        open_ = [s for s in spans if s[0] <= b < s[1]]
        label = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "outside spans"
        gaps.append((label, (a2 - b) * 1e-9))
    gaps.sort(key=lambda g: -g[1])
    return {"busy_s": sum(b - a for a, b in busy) * 1e-9, "window_s": window_s,
            "device_ops": by_op, "device_op_counts": counts, "idle_gaps": gaps[:10]}


def load_metric(name: str, root: Path = ROOT):
    """The reader of per-layer metric ``name``: ``<root>/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"perfbench.metrics.{name}",
                                                  root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def run(cell: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", benchmark: Optional[dict] = None, spec=None) -> dict:
    """One run of ``cell``: returns the result line's object.  ``spec``
    (workload, configuration, mix) stands in for the cell's files."""
    wl, conf, mix = spec or load_cell(cell)
    benchmark = benchmark or json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    weights = model_weights(conf, seed, dev)
    q0 = qnet_weights(seed, dev)
    fed = generator.make_federation(mix, conf["vocab_size"], seed, dev)
    from repro_torch.obs.recorder import RunRecorder

    recorder = RunRecorder() if trace else None   # a span opens a profiler range
    srv, policy = build_program(conf, mix, fed, weights, q0, seed, dev, observe=recorder)
    prog_rec, log = checked_rounds(srv, policy, mix, weights, q0)
    del weights
    sync()
    setup_s = time.perf_counter() - t_start

    # ---- the window -------------------------------------------------------
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    times, results = [], []
    prof_info = None
    if recorder is not None:
        recorder.records.clear()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = time.perf_counter()
        if trace and len(times) == 1:
            prof_info = _profiled(srv, policy, sync, results, times)
            continue
        results.append(srv.run_round(policy))
        times.append(time.perf_counter() - a)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    sync()
    attempted = len(results)
    failed = sum(1 for r in results if not (math.isfinite(r.test_loss)
                                            and len(r.selected) == mix["k"]))

    # ---- metrics ----------------------------------------------------------
    if trace:
        trained = _trained_seqs(results, mix, fed.sizes)
        rec = {"rounds": recorder.records, "profile": prof_info, "window_s": window_s,
               "round_flops": [flops.round_flops(conf, mix["seq_len"], t, mix["test_seqs"])
                               for t in trained],
               "config": conf, "mix": mix, "peaks": {"bf16": flops.H100_BF16_FLOPS}}
        metrics = {}
        for m in benchmark["per_layer"]:
            if "workloads" in m and cell not in m["workloads"]:
                continue
            value = load_metric(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {
            "round_s": {"value": window_s / attempted, "unit": "s"},
            "round_p90_s": {"value": (statistics.quantiles(times, n=10, method="inclusive")[8]
                                      if len(times) > 1 else times[0]), "unit": "s"},
            "peak_mem_gb": {"value": peak / 1e9, "unit": "GB"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }

    # ---- the check --------------------------------------------------------
    from repro_torch.fl.engine import _bucket_step
    from repro_torch.obs.profiling import clear_profiler

    clear_profiler()
    del srv, policy, results, fed
    _bucket_step.cache_clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers, _ = reference_check(prog_rec, log, conf, mix, seed, dev)
    limits = wl.get("limits", {})
    correct = check.verdict(numbers, limits) and failed == 0
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if trace and prof_info is not None:
        out["device"].update(busy_s=prof_info["busy_s"], window_s=prof_info["window_s"])
        ops = sorted(prof_info["device_ops"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in ops],
                            "idle_gaps": [[k, v] for k, v in prof_info["idle_gaps"]]}
    out["checks"] = check.table(numbers, limits)
    return out


def _profiled(srv, policy, sync, results, times):
    """``PROFILED_ROUNDS`` rounds under ``torch.profiler``; their record."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        a = time.perf_counter()
        for _ in range(PROFILED_ROUNDS):
            b = time.perf_counter()
            results.append(srv.run_round(policy))
            times.append(time.perf_counter() - b)
        sync()
        window = time.perf_counter() - a
    info = reduce_profile(prof.profiler.kineto_results.events(), window)
    info["rounds"] = PROFILED_ROUNDS
    return info


def _trained_seqs(results, mix: dict, sizes: np.ndarray) -> List[int]:
    """Sequences trained in each round, padding left out: FedRank's probes
    one epoch each and its survivors the other ``l_ep - 1``; FedAvg's
    survivors ``l_ep``."""
    out = []
    for r in results:
        lost = set(r.failed.tolist()) | set(r.stragglers.tolist())
        kept = [int(i) for i in r.selected if int(i) not in lost]
        n = int(sizes[kept].sum())
        if mix["policy"] == "fedrank":
            out.append(int(sizes[r.probe_set].sum()) + n * (mix["l_ep"] - 1))
        else:
            out.append(n * mix["l_ep"])
    return out


def forbidden_modules(modules=None) -> List[str]:
    """Top-level module names of JAX or the JAX package that are loaded."""
    modules = sys.modules if modules is None else modules
    banned = {"jax", "jaxlib", "flax", "repro"}
    return sorted({name.split(".")[0] for name in modules} & banned)
