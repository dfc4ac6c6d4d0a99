#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. device and build — refuses to run without CUDA, prints the card's name and
   power limit (``nvidia-smi``), builds the CUDA kernels from this checkout;
2. every kernel against its plain PyTorch version on the card, over sizes,
   masks, biases, tie patterns, hidden widths and the kernel's limits, with
   the tolerance stated below;
3. kernel timings (CUDA events, warm-up, median of 25) beside the plain
   version's and the least time the card could take (the bound);
4. the main path: the CPU and the card agree on a small run, then
   ``FLServer`` rounds at 1000 devices on the card, ``fedavg`` then
   ``fedrank``, with every kernel's launch count read around them;
5. one more FedRank round under ``torch.profiler``: device busy time, idle
   share and the kernels that take it;
6. a ``kernels`` line, then the card line, then ``{"ok": true, ...}``.

Kernel tolerance: values within 1e-5 * max(1, |v|) of the plain version's
(fp32 sums in another order); indices equal wherever the plain version's
adjacent score gap exceeds twice that; indices exactly equal where scores tie
exactly (duplicated rows, quantised scores, masked rows).

The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
H100_FP32_FLOPS = 67e12      # published fp32 (non-tensor) peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12   # published HBM3 bandwidth, SXM
HIDDEN = 64                  # the Q-net's hidden width (core/qnet.py)


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def require(ok, what="") -> None:
    """A check that holds under any interpreter flags (``assert`` goes
    away under ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# select_topk: inputs, comparison, bound
# ---------------------------------------------------------------------------


def topk_inputs(torch, n, f, seed, *, h=HIDDEN, masked_frac=0.3,
                zero_net=False, dup_groups=0, int_bias=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    shapes = {"w1": (f, h), "b1": (h,), "w2": (h, h), "b2": (h,),
              "w3": (h, 1), "b3": (1,)}
    params = {k: (torch.zeros(s, device=dev) if zero_net else normal(*s, scale=0.3))
              for k, s in shapes.items()}
    if dup_groups:
        base = normal(dup_groups, f)
        feats = base[torch.randint(0, dup_groups, (n,), generator=g, device=dev)]
    else:
        feats = normal(n, f)
    mask = (torch.rand(n, generator=g, device=dev) > masked_frac).float()
    if int_bias:
        bias = torch.randint(0, 4, (n,), generator=g, device=dev).float()
    elif dup_groups:
        bias = torch.zeros(n, device=dev)
    else:
        bias = normal(n)
    return params, feats.contiguous(), mask, bias


def check_topk(torch, ref_v, ref_i, got_v, got_i, k, exact):
    """ref_*: the plain version's full ordering.  Returns max |value error|."""
    from repro_torch.kernels.select_topk.ref import NEG_INF

    rv, ri = ref_v.double().cpu(), ref_i.cpu()
    gv, gi = got_v.double().cpu(), got_i.cpu()
    require(gv.shape == (k,) and gi.shape == (k,), (gv.shape, gi.shape))
    scale = torch.clamp(rv[:k].abs(), min=1.0)
    err = (gv - rv[:k]).abs()
    require(bool((err <= TOL * scale).all()), f"values off: max err {float(err.max())}")
    require(len(set(gi.tolist())) == k, "duplicate indices")
    if exact:
        require(torch.equal(gi, ri[:k]), "indices differ on an exact-tie case")
        return float(err.max())
    gap = (rv[1:] - rv[:-1]).abs()
    sentinel = (rv[1:] == NEG_INF) & (rv[:-1] == NEG_INF)
    near = (gap <= 2 * TOL * torch.clamp(rv[1:].abs(), min=1.0)) & ~sentinel
    exempt = torch.zeros(len(rv), dtype=torch.bool)
    exempt[:-1] |= near
    exempt[1:] |= near
    keep = ~exempt[:k]
    require(torch.equal(gi[keep], ri[:k][keep]), "indices differ off near-ties")
    return float(err.max())


def topk_bound_ms(n, f, h, k):
    """Least time for the work: 2N(FH + H^2 + H) fp32 FLOPs on CUDA cores, or
    the bytes (inputs read once, outputs written once) over HBM bandwidth."""
    flops = 2.0 * n * (f * h + h * h + h)
    nbytes = 4.0 * (n * f + 2 * n + f * h + h * h + 3 * h + 1) + 8.0 * k
    t_ops, t_bytes = flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(torch, fn, reps=25, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernel_vs_plain(torch):
    from repro_torch.kernels.select_topk.kernel import select_topk_cuda
    from repro_torch.kernels.select_topk.ref import select_topk_ref

    cases = []
    for n in (1, 7, 513, 100_000, 1_000_000):
        for f in (6, 14):
            for k in (1, 10, 64):
                cases.append(dict(n=n, f=f, k=min(k, n), seed=n + 100 * f + k))
    cases += [
        # the main path's two calls: fleet cut and probe-cohort ordering
        dict(n=1000, f=6, k=20, seed=5, name="main-probe-set"),
        dict(n=25, f=6, k=25, seed=6, masked_frac=0.0, name="main-select"),
        dict(n=1000, f=6, k=64, seed=7, masked_frac=1.0, exact=True,
             name="all-masked"),
        dict(n=20_000, f=6, k=64, seed=8, dup_groups=800, masked_frac=0.2,
             exact=True, name="duplicate-rows"),
        dict(n=100_000, f=14, k=64, seed=9, zero_net=True, int_bias=True,
             masked_frac=0.2, exact=True, name="quantised-scores"),
        # the kernel's other hidden-width variants and its limits: H=20 pads
        # to 32; F=64, H=128 needs more than 48 KB of shared memory; k=1000
        # keeps more than a tile's 256 rows per list
        dict(n=3000, f=3, h=20, k=10, seed=10, name="hidden-32"),
        dict(n=5000, f=64, h=128, k=64, seed=11, name="f64-hidden-128"),
        dict(n=100_000, f=6, k=1000, seed=12, name="k-1000"),
        dict(n=1000, f=6, k=1000, seed=13, name="k-equals-n"),
    ]
    max_err, summary = 0.0, []
    for c in cases:
        kw = {key: c[key] for key in ("h", "masked_frac", "zero_net",
                                      "dup_groups", "int_bias") if key in c}
        params, feats, mask, bias = topk_inputs(torch, c["n"], c["f"], c["seed"], **kw)
        got_v, got_i = select_topk_cuda(params, feats, mask, bias, k=c["k"])
        ref_v, ref_i = select_topk_ref(params, feats, mask, bias, k=c["n"])
        torch.cuda.synchronize()
        err = check_topk(torch, ref_v, ref_i, got_v, got_i, c["k"],
                         c.get("exact", False))
        if c.get("name") == "duplicate-rows":
            # within each tie group of identical rows, indices ascend
            groups = {}
            for v, i in zip(got_v.tolist(), got_i.tolist()):
                groups.setdefault(v, []).append(i)
            require(all(g == sorted(g) for g in groups.values()))
        if c.get("name") == "all-masked":
            require(torch.equal(got_i.cpu(), torch.arange(c["k"])))
        max_err = max(max_err, err)
        summary.append([c.get("name", "random"), c["n"], c["f"],
                        c.get("h", HIDDEN), c["k"], err])
    emit(phase="kernel_vs_plain", kernel="select_topk", cases=len(cases),
         tolerance="1e-5*max(1,|v|)", max_abs_err=max_err, results=summary)
    return max_err


def phase_timings(torch, card):
    from repro_torch.kernels.select_topk.kernel import select_topk_cuda
    from repro_torch.kernels.select_topk.ref import select_topk_ref

    rows = {}
    # 1e6 candidates; the main path's fleet cut (probe_set, N=1000, k=20)
    # and its probe-cohort ordering (select, N=25, k=25)
    # and the "telemetry" feature width (F=14) at 1e6
    for label, n, f, k in (("fleet_1e6", 1_000_000, 6, 64),
                           ("fleet_1e6_f14", 1_000_000, 14, 64),
                           ("main_probe_set", 1000, 6, 20), ("main_select", 25, 6, 25)):
        params, feats, mask, bias = topk_inputs(torch, n, f, seed=n + f)
        ms = cuda_ms(torch, lambda: select_topk_cuda(params, feats, mask, bias, k=k))
        plain = cuda_ms(torch, lambda: select_topk_ref(params, feats, mask, bias, k=k))
        bound, bound_by = topk_bound_ms(n, f, HIDDEN, k)
        rows[label] = dict(n=n, f=f, h=HIDDEN, k=k, ms=ms, plain_ms=plain,
                           bound_ms=bound, bound_by=bound_by)
        emit(phase="timing", kernel="select_topk", shape=label, card=card,
             **rows[label])
    return rows


def small_data(n_samples, n_clients):
    from repro_torch.data import FederatedData, dirichlet_partition, make_classification_data

    train, test = make_classification_data(n_samples=n_samples, seed=0)
    return FederatedData(train, test,
                         dirichlet_partition(train.y, n_clients, 0.1, seed=0))


def phase_cpu_agreement(torch):
    """One round of each policy at a small size on the CPU and on the card,
    from the same seeds: the cohorts are equal, the outcomes close."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy

    data = small_data(4000, 50)
    for name in ("fedavg", "fedrank"):
        results = {}
        for dev in ("cpu", "cuda"):
            cfg = FLConfig(n_devices=50, k_select=5, rounds=1, l_ep=2,
                           scenario="high-churn", seed=3)
            srv = FLServer(cfg, MLPTask(), data, device=dev)
            kw = dict(k=5, seed=0, device=dev) if name == "fedrank" else {}
            results[dev] = srv.run_round(build_policy(name, **kw))
        a, b = results["cpu"], results["cuda"]
        require(a.probe_set.tolist() == b.probe_set.tolist(), (a.probe_set, b.probe_set))
        require(a.selected.tolist() == b.selected.tolist(), (a.selected, b.selected))
        require((a.r_t, a.r_e) == (b.r_t, b.r_e))
        require(abs(a.acc - b.acc) <= 2e-3 and abs(a.test_loss - b.test_loss) <= 1e-3)
        emit(phase="cpu_vs_card", policy=name, cohort=b.selected.tolist(),
             acc_cpu=a.acc, acc_card=b.acc, loss_cpu=a.test_loss,
             loss_card=b.test_loss)


def phase_main_path(torch):
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy
    from repro_torch.kernels.select_topk.kernel import select_topk_cuda

    t0 = time.perf_counter()
    data = small_data(64_000, 1000)
    emit(phase="main_data", samples=64_000, clients=1000,
         seconds=time.perf_counter() - t0)
    cfg = FLConfig(n_devices=1000, k_select=10, rounds=3, l_ep=5,
                   scenario="high-churn")
    select_topk_cuda.launches = 0                 # every count to 0
    per_policy = {}
    for name in ("fedavg", "fedrank"):
        srv = FLServer(cfg, MLPTask(), data, device="cuda")
        policy = build_policy(name, k=10) if name == "fedrank" else build_policy(name)
        launched = []
        for _ in range(cfg.rounds):
            before = select_topk_cuda.launches
            res = srv.run_round(policy)
            launched.append(select_topk_cuda.launches - before)
            online = srv.pool.available()
            sel = res.selected.tolist()
            require(len(sel) == len(set(sel)) <= cfg.k_select, sel)
            require(bool(online[res.selected].all()), "offline device selected")
            require(math.isfinite(res.acc) and math.isfinite(res.test_loss))
            emit(phase="main", policy=name, round=res.round, acc=res.acc,
                 test_loss=res.test_loss, r_t=res.r_t, r_e=res.r_e, cohort=sel,
                 probe=len(res.probe_set), failed=res.failed.tolist(),
                 host_s=res.host_time_s, select_topk_launches=launched[-1])
        for key, t in srv.global_params.items():
            require(t.is_cuda and bool(torch.isfinite(t).all()), key)
        per_policy[name] = launched
    launches = select_topk_cuda.launches          # read just after
    require(all(n >= 2 for n in per_policy["fedrank"]), per_policy)
    require(launches > 0)
    emit(phase="main_launches", select_topk=launches, per_round=per_policy)
    return launches, srv, policy


def phase_profile(torch, srv, policy):
    """One more FedRank round under torch.profiler: where the round's time
    goes on the card.  The profiler slows the host, so the wall time here
    is longer than an unprofiled round's (the main-path lines give those)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = srv.run_round(policy)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    busy_s = sum(dev_us(e) for e in rows) / 1e6
    sel_s = sum(dev_us(e) for e in rows
                if "score_tile_topk" in e.key or "merge_pairs" in e.key) / 1e6
    top = sorted(rows, key=dev_us, reverse=True)[:8]
    emit(phase="profile", policy=policy.name, round=res.round, wall_s=wall,
         device_kernels=sum(e.count for e in rows), device_busy_s=busy_s,
         device_idle_share=(1.0 - busy_s / wall) if busy_s else "not measured",
         select_topk_device_s=sel_s,
         top_device_ms=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.select_topk import kernel as select_topk_kernel

    # ---- 1: device and build -------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    lib = select_topk_kernel.build()
    ptxas = [ln.strip() for ln in select_topk_kernel.build_log.splitlines()
             if "Used" in ln or "spill" in ln]
    emit(phase="build", kernel="select_topk", seconds=time.perf_counter() - t0,
         library=str(lib.relative_to(ROOT)), ptxas=ptxas)

    # ---- 2-3: kernels against their plain versions, timings -----------
    max_err = phase_kernel_vs_plain(torch)
    timings = phase_timings(torch, card)

    # ---- 4: the main path ----------------------------------------------
    phase_cpu_agreement(torch)
    launches, srv, policy = phase_main_path(torch)
    phase_profile(torch, srv, policy)

    # ---- 5: kernels line, card line, result ----------------------------
    main_shape = timings["main_probe_set"]
    print(json.dumps({"kernels": [{
        "name": "select_topk", "route": "cuda",
        "source": "src/repro_torch/csrc/select_topk.cu",
        "replaces": "src/repro/kernels/select_topk/kernel.py:98",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None,
        "shape": {k: main_shape[k] for k in ("n", "f", "h", "k")},
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
