#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [STEP ...]

With no argument it runs every step below.  Given step names (``build``,
``select_topk``, ``pairwise_rank``, ``fleet_state``, ``flash_attention``,
``mamba_rwkv6``, ``sgd_update``, ``cpu_vs_card``, ``full_width``, ``path1_sync`` to
``path5_async``, ``vmapped``, ``path8_hierarchy``, ``path6_lm``,
``path7_ssm``, ``path9_lm_fl``, ``obs``, ``path10_lm_train``,
``path11_zoo``, ``path12_mesh``) it builds
every library, runs only
those steps and ends with the summary line and the card line; the
``kernels`` line and the last line need the whole run.

Phases, each printing JSON lines; any failure raises and exits non-zero:

1. device and build — refuses to run without CUDA, prints the card's name and
   power limit (``nvidia-smi``), builds the CUDA libraries from this checkout
   (``select_topk``, ``pairwise_rank``, ``fleet_state``, ``flash_attention``,
   ``mamba``, ``rwkv6`` and ``sgd_update``, one ``nvcc`` each, started
   together), prints
   ``ptxas``'s registers and spills (and fails if ``mamba``, ``rwkv6`` or
   ``select_topk`` spills), and the launch configuration of every
   ``mamba`` and ``rwkv6`` instantiation and of ``select_topk`` at each
   timed shape (route, rows a thread, grid, registers, local bytes) with
   the resident CTAs per SM that
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports;
2. every kernel against its plain PyTorch version on the card, with the
   tolerances stated below: ``select_topk`` over sizes, masks, biases, tie
   patterns, hidden widths, wide nets (F=96, H=256; F=1000) and k past
   1024 (k=2000 at N=1e5), duplicate rows at N=1e6, k at each route's
   K_pad boundary (256, the largest carried list; 257, the smallest merge
   tree), each scoring path's widths (H=320, the widest with activations
   in shared memory; H in {384, 515, 600, 1024} through the scratch), the
   op the paths call (host arrays, one C call) at the main path's two
   shapes, and the carried list's winners against the merge tree's (the
   same bits, on each scoring path, up to 1e6 rows); ``pairwise_rank``
   by its two routes (the fused loss-and-gradient launch through the
   autograd Function, the loss-only launch under ``torch.no_grad``) over N
   in {1, 2, 7, 30, 31, 32, 33, 127, 128, 129, 1000, 8192}, B in {1, 16,
   70000}, hard and soft targets, plus all-masked rows, duplicated scores,
   tied targets, a fractional mask and well-ranked cohorts (scores ordered
   as the hard targets, 4, 10 or 20 apart: losses down to ~1e-9); ``fleet_state`` with exact equality, by the device wrapper and by
   the one-call host lookup, over both trace fixtures at fleet sizes 1 to
   1e6, the split-time edge cases, random traces and a 1024-device
   four-week synthetic trace at 1e5 queries (the uploaded CSR offsets
   equal each trace's);
   ``flash_attention`` in fp32 and bf16 over S in {1, 7, 128, 129, 1000}
   x G in {1, 4, 5, 8} x Dh in {64, 120, 128} x causal/bidirectional x
   window in {None, 64, 1024}, ten cases at S = 4096 and 8192 (windows up
   to 4096), gemma-7b's Dh=256 (G=1, S in {129, 1000}), the tensor-core
   kernel's row layouts (G in {16, 64} at S in {7, 129}; G=5 with windows
   of 1, 17 and 63 keys; Dh=120 at S in {65, 200, 1001}), path 6's own
   shapes (Yi-6B's prefill, h2o-danube's 5000-token windowed prefill) and
   path 11's (whisper-medium's bidirectional encoder: B=4, S=1500, 16
   heads over 16, Dh=64; OLMoE's prefill: B=4, S=1024, 16 over 16,
   Dh=128), the
   largest error reported by route (bf16 with Dh <= 128 takes the
   tensor-core kernel, the rest the CUDA-core one);
   ``mamba`` over T in {1, 2, 7, 64, 65, 1000} x inner in {64, 100, 1600} x
   state in {8, 16} x B in {1, 4} x zero and random h0, every lane split of
   the state (state 1 to 64), path 7's own shapes (Hymba's prefill: B=4,
   T=2048, inner 1600, state 16, B and C strided views of one projection;
   a decode step, T=1; B=1 at T=8192) and a split-T composition (two calls
   with the state carried against one); ``rwkv6`` over T in {1, 7, 64, 65,
   1000} x n in {16, 32, 64} x B*H in {1, 3, 160} x a mild (logw =
   -exp(N(-2, 1))) and a strong (-exp(N(1, 1)), where the chunked form
   overflows) decay, n in {5, 48}, rows that are not contiguous (n = 64,
   B*H in {3, 160}: the kernel's 4-byte copies), path 7's own shapes in the
   model's layout, views (RWKV6-3B's prefill: B=4, T=1024, 40 heads of 64,
   model and strong decay; a decode step; B=1 at T=8192, model and strong
   decay) and a split-T composition; ``sgd_update`` against
   ``fl/client.py::_sgd_leaf`` client by client, bit for bit, at the main
   path's leaves (Yi-6B's embedding, 10 x 64000 x 4096 bf16; an OLMoE
   expert leaf, 10 x 64 x 2048 x 1024; an fp32 MLP leaf), each broadcast
   (client stride 0) and stacked, and at a ragged end, an unaligned start,
   client strides of their own, fp16 and one client;
3. kernel timings (CUDA events, warm-up, median of 25; ``select_topk``
   the median of 50 over two turns) beside the plain version's (in turns), the least time the card could take (the bound) and a one-call
   PyTorch yardstick: for ``select_topk`` none (and the op at the main
   path's two shapes, host included, beside the sequence it replaced, and
   the device kernels per op call from ``torch.profiler``, which must be
   one), for ``fleet_state`` ``torch.searchsorted`` over the f64
   key (and the op-level lookup at N=1000, host included, beside numpy's
   ``searchsorted``: the reference's host path), for ``pairwise_rank`` none
   (the fused launch beside the loss-only one; the design it replaced is
   timed from a checkout of it by ``scripts/pairwise_rank_precision.py``),
   for ``flash_attention`` ``scaled_dot_product_attention`` (``is_causal``,
   or a boolean causal-and-window mask) at Yi-6B's prefill (B=4, S=1024),
   S=8192 and S=32768, h2o-danube's (window 4096; S=5000 and 8192),
   Hymba's attention (window 1024; path 7's B=4, S=2048 and B=1, S=8192),
   whisper's encoder (``is_causal=False``) and OLMoE's prefill;
   ``mamba`` and ``rwkv6`` at path 7's
   shapes and at T=8192 (B=1), beside the plain version and the bound (no
   one PyTorch call computes either); then each kernel's dispatcher op
   (``repro_torch::flash_attention`` at Yi-6B's prefill shape,
   ``repro_torch::selective_scan`` and ``repro_torch::wkv6`` at a Hymba and
   an RWKV6 decode step, B=4, T=1) against a direct call of its ``*_cuda``
   wrapper: the same bits, exactly one launch a call each, and the host
   microseconds a call of each (from the call to its return, the card idle
   before each call; medians of 400, in turns).  The bounds come from
   ``src/repro_torch/kernels/work.py``, the formulas the dry-run's counter
   books; ``sgd_update`` at the main path's leaves beside the plain version
   (the executor's update before it), the bytes' bound and
   ``torch.add(a, g, alpha=-lr)`` (timed only), and at least 80% of 3.35
   TB/s at Yi's stacked embedding;
4. the CPU and the card agree: one round of every policy at 50 devices picks
   the same cohorts, 5 imitation-pretraining steps from the same Q-net give
   the same Q-net, an asynchronous trace run schedules the same jobs, one
   hierarchical FedRank round and one ``krum`` round on
   ``byzantine-signflip`` give the same cohorts and adversaries (params
   within 1e-4), one LM FL round (yi-6b smoke, fp32, 8 devices, k=2) gives
   the same cohort and params within 1e-4, 3 ``make_train_step`` steps
   (yi-6b under ``impl="naive"`` and ``"blocked"``, hymba and rwkv6 under
   ``"blocked"``; smoke configs, fp32, the same ``lm_batches``) give the
   same losses, step-1 gradients and params within 1e-4, and the
   yi-6b, h2o-danube, hymba and rwkv6 smoke LMs give the same logits over a
   prefill (by the kernels) and 8 decode steps; at full width (2 layers,
   fp32) prefill by the kernels and decode through the ring cache and the
   recurrent states reproduce the naive full forward pass (Yi-6B,
   h2o-danube and Hymba past their windows, RWKV6-3B);
5. path 1, synchronous rounds: ``FLServer`` at 1000 devices on the card,
   ``fedavg`` then ``fedrank`` (cold start), then one more FedRank round
   under ``torch.profiler``;
6. path 2, imitation learning at the paper's configuration: demonstrations
   from the oort, harmony and fedmarl experts (15 rounds each), 200
   synthetic cohorts, 2000 ``pretrain_qnet`` steps (batch 16; exactly one
   pair-kernel launch a step, the fused one), then 3
   FedRank rounds from the pretrained Q-net; 50 more pretraining steps under
   ``torch.profiler``;
7. path 3, one round of each baseline at 1000 devices;
8. path 4, trace replay: 3 ``fedavg`` and 3 ``fedrank`` synchronous rounds
   on ``trace-synthetic-week`` at 1000 devices;
9. path 5, the asynchronous engine (``mode="async"``, concurrency 3k,
   polynomial staleness, k=10): ``fedavg`` and ``fedrank`` for 5
   aggregations each on ``trace-synthetic-week`` and ``fedrank`` on
   ``high-churn``, one more aggregation under ``torch.profiler``, and the
   batched event loop against its sequential oracle;
   then ``vmapped``: the configurations of paths 1 (``fedavg`` and
   ``fedrank``), 4 and 5 under ``executor="vmapped"`` and ``"sequential"``
   in turns, 3 rounds or aggregations each: equal ``fedavg`` cohorts and
   params within 1e-5 per round (sync rounds start from one global model),
   host s per round, and one profiled round or aggregation of each (device
   kernels, idle share);
   then path 8, ``path8_hierarchy``, at path 1's width with the vmapped
   executor: on ``hierarchical`` (budgets 4/3/3) ``fedavg`` and ``fedrank``,
   3 sync rounds and 3 ``HierarchicalAsyncEngine`` aggregations each, under
   ``region_exec="stacked"`` and ``"sequential"`` in turns (identical
   cohorts, failures, clock and tier lags, params within 1e-5; every cut
   online, unique, in its region and within its budget; ``select_topk``
   launches per round; one profiled round or aggregation), 3 FedRank rounds
   on ``regional-outage`` (a dark region is skipped), and
   ``byzantine-signflip`` under ``mean``, ``trimmed_mean`` (trim 3),
   ``coordinate_median``, ``krum`` and ``multi_krum`` (f 3), sync and async
   (every adversary in the static mask and in its cohort);
10. path 6, LM serving at full width and depth in bf16: ``serve`` on Yi-6B
    (batch 4, prompt 1024, 32 new tokens; one ``flash_attention`` launch per
    layer, every one on the tensor-core kernel), on h2o-danube-3-4b (batch
    1, prompt 5000, past its 4096 window, 16 new tokens) and a
    ``ContinuousBatcher`` on Yi-6B (4 slots, 8
    requests, prompts of 16-128 tokens, 16 new tokens each; prompts go token
    by token through decode, so no attention kernel launches), then one
    Yi-6B serve call (4 new tokens) under ``torch.profiler``;
11. path 7, SSM serving at full published width and depth in bf16:
    ``serve`` on Hymba-1.5B (batch 4, prompt 2048, past its 1024 window, 32
    new tokens; exactly 32 ``flash_attention`` launches, all on the
    tensor-core kernel, and 32 + 32 x 32 ``mamba`` launches: one per layer
    in the prefill and in each decode step),
    on RWKV6-3B (batch 4, prompt 1024, 32 new tokens; exactly 32 + 32 x 32
    ``rwkv6`` launches) and a ``ContinuousBatcher`` on RWKV6-3B (4 slots, 8
    requests, prompts of 16-128 tokens, 16 new tokens each; exactly one
    ``rwkv6`` launch per layer and decode step, nothing else), then
    one serve call of each model (4 new tokens) under ``torch.profiler``
    (the profiles report each flash kernel's device time apart), and decode
    alone (batch 4 after a 128-token prefill; depth cut to 4 of the 32
    layers, 4 profiled and 16 timed steps) by the kernels and with the
    mixers' plain versions, in turns: kernels, SSM launches, device and
    wall ms per step;
12. path 9, ``path9_lm_fl``, an LM as the FL global model: Yi-6B at its
    full published width (bf16, weights from a seed), depth cut to 2
    layers (0.87 B parameters; full depth, 12.1 GB a copy, does not fit the
    vmapped executor's stacked copies and gradients), 32 devices, k=4,
    l_ep=1, local batch 8, sequences of 64 tokens from ``make_lm_stream``:
    one ``fedavg`` and one ``fedrank`` round (a fresh Q-net), each under the
    sequential and the vmapped executor (cohorts online, unique, at most k;
    a finite test loss; exactly 2 ``select_topk`` launches a FedRank round;
    one ``sgd_update`` launch a leaf and step under the vmapped executor,
    none under the sequential one;
    the vmapped round's cohort equal to the sequential one's and its bf16
    params within two bf16 ulps at each leaf's largest magnitude; host s a
    round and peak memory), then one FedRank round under
    ``torch.profiler``; then one FedRank round of olmoe-1b-7b at its
    published width (64 experts, top 8), 1 layer, under both executors
    (the same cohort; every leaf, the fp32 router and norms too, within
    two bf16 ulps at its largest magnitude); each round reports its layer
    checkpoints (``cfg.remat`` holds under the vmapped executor too, one a
    layer and grad step); then ``lm_fl_remat``: Yi-6B at its published
    width, 4 layers, a ``fedavg`` round under the vmapped executor (8
    devices, k=4, l_ep=1, local batch 8, 512-token sequences) with
    ``remat=True`` and ``remat=False`` from the same init, in turns (on,
    off, off, on): the same cohort, params within two bf16 ulps, a finite
    test loss, 4 layer checkpoints a grad step with remat and none without,
    and the remat round's peak memory (over what it starts with) below the
    plain round's by at least half the activations predicted from the
    shapes (one layer's saved tensors x 3 layers x 4 clients; the saved
    bytes of one layer measured by ``saved_tensors_hooks`` beside it), with
    both peaks and host s;
13. ``obs``: observed runs (``FLConfig.observe``) at paths 1 and 5's sizes,
    sync FedRank rounds on ``high-churn`` and async FedRank aggregations on
    ``trace-synthetic-week``, each beside the unobserved run in turns (host
    s per round with and without the recorder); the records under
    ``build/obs/`` pass the port's ``check_run`` (coverage >= 0.5) and list
    ``executor.*``, ``select_topk.cuda`` and ``fleet_state.cuda`` with fenced
    times; one round inside ``trace_gate`` writes a Chrome trace;
14. path 10, ``path10_lm_train``, LM training: Yi-6B at its published
    width, depth cut to 4 layers (1.22 B parameters), bf16, ``remat=True``,
    batch 4 x 1024 tokens from ``make_lm_stream``, AdamW with
    ``linear_warmup_cosine`` (lr 3e-4): 20 steps under ``impl="naive"`` and
    20 from the same init under ``"blocked"`` (finite losses, the last below
    the first; step 1's loss and gradients of the two routes within a bf16
    tolerance; ms per step, tokens/s, model FLOP rate, peak memory), one step
    with remat on and off (equal loss and gradients, the peak memory of
    each), one step under ``torch.profiler``; Hymba-1.5B and RWKV6-3B at
    full width, 2 layers, batch 2 x 512, 3 steps each; the kernel routes
    refuse params that require grad; a bf16 smoke train state through
    ``save_pytree``/``load_pytree`` bit-equal and ``latest_checkpoint``;
    ``train()`` on the card reduces the loss.  Every kernel counter stays 0:
    the kernels have no backward, and training takes the plain routes, as
    the reference's does;
15. path 11, ``path11_zoo``, the rest of the zoo: (a) smoke configs in
    fp32 of olmoe-1b-7b, phi3.5-moe, whisper-medium and internvl2-76b (with
    random frontend embeddings) on the CPU and the card from the same
    weights: forward, prefill and 8 decode steps' logits, aux and the
    loss's gradients; the MoE's sort dispatch against the dense one on the
    card (1, 2 and 4 groups); one ``LMTask`` FedRank round of olmoe-smoke
    under both executors on both devices (one cohort); (b) serving at the
    published widths in bf16 through ``serve()``, batch 4, 32 new tokens:
    olmoe-1b-7b at full depth (prompt 1024; 16 ``flash_attention``
    launches), phi3.5-moe at 4 layers (prompt 1024; 4), whisper-medium at
    full depth (1500 frames, prompt 32; 24 bidirectional and 24 causal
    launches) and internvl2-76b at 2 layers (256 image and 768 text
    tokens; 2), every launch on the tensor-core kernel; prefill s, decode
    tokens/s, peak memory and the MoE prefill's dropped fraction; a
    ``ContinuousBatcher`` on olmoe-1b-7b (4 slots, 8 requests; no kernel);
    (c) 3 ``make_train_step`` steps of each at its published width, bf16,
    remat, on one batch (the loss falls from step 1 to step 3; the MoE
    aux nonzero): olmoe-1b-7b at 4 layers and phi3.5-moe at 1 (AdamW, 4 x
    1024), whisper-medium at full depth (AdamW, 4 x 1024 over 1500
    frames), internvl2-76b at 1 layer (SGD with momentum, 2 x (256 +
    512)); ms a step and peak memory; no kernel launches;
16. path 12, the mesh tooling: six dry-runs start first, each a
    process of its own over a fake group (``python -m
    repro_torch.launch.dryrun``: yi-6b ``train_4k``, olmoe-1b-7b
    ``decode_32k``, hymba-1.5b ``prefill_32k`` at full depth and width
    through the kernel ops (``--impl flash``) and rwkv6-3b's smoke
    ``train_4k``, whose batch of 8 is smaller than the data axis, on the
    production 16x16 mesh; path 10's Yi-6B step and path 6's Yi-6B prefill
    (4 x 1024, full depth, ``--impl flash``) on a 1x1 mesh), and run while
    this process (a) starts a one-rank NCCL
    group and a 1x1 cuda mesh, lays Yi-6B, RWKV6-3B and Hymba-1.5B (full
    width, 2 layers, bf16) out by ``param_specs`` as DTensors, and runs a
    prefill of 4 x 1024 by the kernels (on the local shards through
    ``local_map``) and 8 decode steps against the same run on plain
    tensors (logits within one bf16 ulp, the same launches, host ms a
    decode step of each), then 3 Yi-6B train steps (``impl="blocked"``, 4 x
    1024) both ways (each loss within one bf16 ulp); (b) runs one path-1
    FedRank round under ``VmappedExecutor(mesh=)`` the 1x1 mesh and under
    ``mesh=None`` (equal cohorts, params within 1e-6, host s each); (c)
    reads the dry-runs (each ``ok``, its cost counter exact on a sharded
    MLP under this torch; the flash ones through their kernel ops, one call
    a layer; per-device FLOPs, bytes, wire bytes, seconds and
    roofline rows); (d) prints the 1x1 train cost's compute and
    memory terms beside the ms path 10 measured (or 5 steps measured here
    when path 10 did not run), and the 1x1 prefill's beside path 6's
    prefill measured here (3 calls after a warm-up; serve()'s first call in
    path 6 beside it);
17. a ``summary`` line (each step's status, host seconds, its phases'
    seconds, largest error and device idle shares; printed also when a step
    fails, before the error),
    a ``kernels`` line (seven entries, one per TPU kernel of the repo and
    ``sgd_update``, each
    with its times and launches; ``select_topk`` adds its design and the op's
    time host included, ``pairwise_rank`` its loss-only route,
    ``flash_attention`` the route its main shape took; ``flash_attention``,
    ``mamba`` and ``rwkv6`` their launches through the DTensor route), then
    the card line, then
    ``{"ok": true, ...}``.  The last four lines stay within ~12 KB, so that
    a tool that keeps only the end of the output keeps them.

Every kernel wrapper counts its launches.  Each path is driven with every
count set to 0 just before it and read just after; launches made to compare
a kernel with its plain version are not counted.

Tolerances.  ``select_topk``: values within 1e-5 * max(1, |v|) of the plain
version's (fp32 sums in another order); indices equal wherever the plain
version's adjacent score gap exceeds twice that; indices exactly equal where
scores tie exactly (duplicated rows, quantised scores, masked rows).
``pairwise_rank``: loss within 1e-5 * max(1, |loss|); gradient within 1e-5 *
max |g_ref| of its row, and exactly 0 on an all-masked row (fp32 pair sums
in another order; the loss adds fp32 tile sums in fp64; the gradient terms
are fp32 in forms without cancellation, summed in fp64); on well-ranked
cohorts with hard targets the loss also within 1e-5 * |loss| (each term
log1p(e) to a few ulps relative, so a small loss keeps its digits).  The plain version is evaluated in fp64 on the same fp32
inputs: among 70,000 random cohorts some rows' pair terms nearly cancel,
and an fp32 evaluation of either side cannot resolve 1e-5 of what is left.  ``fleet_state``:
exactly equal (the kernel computes the plain version's count).
``sgd_update``: the same bits as ``_sgd_leaf`` (the same two fp32 roundings
and the same rounding back).
``flash_attention`` (inputs N(0, 1); the plain version in fp32 on the same
inputs): fp32 inputs within 2e-5 (fp32 sums over up to 8192 keys in another
order); bf16 inputs within 2^-7 * |ref| + 2e-5 per element (the output is
rounded once to bf16: within one bf16 ulp of its magnitude).  LMs: CPU and
card within 1e-4 on the logits (fp32 sums in another order through two
layers); at full width within 1e-4 * max(1, max |logit|) of the naive
forward, 39x under the 2^-8 relative error of one bf16 rounding of the
attention's probabilities or sums.  LM training: CPU and card within
1e-4 (losses, step-1 gradients over each leaf's largest magnitude, params;
fp32 smoke configs, the step's own optimizer, whose first 3 steps move each
weight by at most 4e-6, so Adam's division by sqrt(nu) cannot turn gradient
noise near 0 into a visible move); at full width in bf16 the two attention
routes within 2^-7 relative on the loss and 2^-5 of each leaf's largest
magnitude on the gradients (each route rounds its attention output to bf16
once, and an entry rounded to a neighbouring value moves everything
downstream by that ulp); remat on and off: equal losses, gradients within
one bf16 ulp at each leaf's largest magnitude (the same kernels, run
again).  The zoo (path 11): CPU and card within 1e-4 on the logits and aux
and on each gradient over its leaf's largest magnitude (fp32 smoke
configs); the MoE's lossless sort dispatch within 1e-5 of the dense one
(the reference test's bound); path 9's olmoe round, vmapped against
sequential, every leaf within two bf16 ulps at its largest magnitude.  ``mamba`` and ``rwkv6`` (fp32 in and
out; the plain version in fp32 on the same inputs): every output and final
state within 2e-5 * max(1, max |ref|) of its row, the (batch, channel) row
of the scan and the (batch, head) row of the WKV (fp32 sums over the state
entries or the n rows in another order, and the kernels' accurate ``expf``
against PyTorch's exp; errors compound along the recurrence, so the bound
is relative to the row's scale, which reaches ~90 for the WKV at n = 64).

The script imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-5
H100_FP32_FLOPS = 67e12      # published fp32 (non-tensor) peak, SXM, 700 W
H100_BYTES_PER_S = 3.35e12   # published HBM3 bandwidth, SXM
# exps a second: the special-function units issue 16 a clock on each of the
# 132 SMs, at the 1.98 GHz the fp32 rate assumes
H100_SFU_EXPS = 132 * 16 * 1.98e9
HIDDEN = 64                  # the Q-net's hidden width (core/qnet.py)


# The summary line: each step's status, its largest error and the device
# idle shares its profiles measured.  Every other number is in the full lines
# above and in the kernels line.
_T0 = time.perf_counter()    # the script's start: the summary's total seconds
_STEPS: dict = {}            # step name -> {"status": ..., "max_err": x, "idle": [...]}
_CURRENT: list = []


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)
    if _CURRENT:
        summary = _STEPS[_CURRENT[-1]]
        for key, val in kw.items():
            if "err" in key and isinstance(val, dict):     # errors by route
                summary[key] = val
            elif "err" in key and isinstance(val, (int, float)):
                summary["max_err"] = max(summary.get("max_err", 0.0), float(val))
            elif key == "device_idle_share" and isinstance(val, (int, float)):
                summary.setdefault("idle", []).append(float(f"{val:.4g}"))


@contextlib.contextmanager
def step(name):
    """A step of main(): "fail" until its body returns; its host seconds
    go into the summary either way."""
    _STEPS[name] = {"status": "fail"}
    _CURRENT.append(name)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _CURRENT.pop()
        _STEPS[name]["seconds"] = round(time.perf_counter() - t0, 1)
    _STEPS[name]["status"] = "pass"


def timed(name, fn, *args, **kw):
    """Run one phase of the current step; its host seconds go into the
    summary under the step's ``phases``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        phases = _STEPS[_CURRENT[-1]].setdefault("phases", {})
        phases[name] = round(time.perf_counter() - t0, 1)


def summary_line(ok, error=None) -> str:
    out = {"ok": ok, "seconds": round(time.perf_counter() - _T0, 1), "steps": _STEPS}
    if error is not None:
        out["error"] = repr(error)[:400]
    return json.dumps({"summary": out}, separators=(",", ":"))


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
                zero_net=False, dup_groups=0, int_bias=False, init_scale=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")

    def normal(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    shapes = {"w1": (f, h), "b1": (h,), "w2": (h, h), "b2": (h,),
              "w3": (h, 1), "b3": (1,)}
    def scale(s):   # 0.3, or the Q-net's init scale N(0, 1 / fan_in)
        return (1.0 / (s[0] if len(s) == 2 else h)) ** 0.5 if init_scale else 0.3

    params = {k: (torch.zeros(s, device=dev) if zero_net else normal(*s, scale=scale(s)))
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


def host_us(torch, fn, calls=1000, warmup=100):
    """Host microseconds per call over ``calls`` back-to-back calls (what
    launch-bound wrappers cost the host), one synchronise at the end
    included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def cuda_ms(torch, fn, reps=25, warmup=5):
    return statistics.median(cuda_times(torch, fn, reps, warmup))


def cuda_times(torch, fn, reps=25, warmup=5):
    """Milliseconds of each of ``reps`` calls, CUDA events around each."""
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
    return times


def cuda_ms_back_to_back(torch, fn, launches=20, reps=5, warmup=5):
    """Milliseconds per call over ``launches`` calls enqueued back to back
    between one pair of CUDA events (median of ``reps``): the device's time
    once the host runs ahead, where ``cuda_ms`` times each call alone and so
    also holds the wrapper's host time before the launch."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# launch counts of every kernel wrapper
# ---------------------------------------------------------------------------


def _wrappers():
    from repro_torch.kernels.pairwise_rank.kernel import (
        pairwise_rank_fused_cuda,
        pairwise_rank_fwd_cuda,
    )
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.fleet_state.kernel import segment_index_cuda
    from repro_torch.kernels.mamba.kernel import selective_scan_cuda
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
    from repro_torch.kernels.select_topk.kernel import select_topk_cuda
    from repro_torch.kernels.sgd_update.kernel import sgd_update_cuda

    return {"select_topk": select_topk_cuda,
            "pairwise_rank_fused": pairwise_rank_fused_cuda,
            "pairwise_rank_fwd": pairwise_rank_fwd_cuda,
            "fleet_state": segment_index_cuda,
            "flash_attention": flash_attention_cuda,
            "mamba": selective_scan_cuda,
            "rwkv6": wkv6_cuda,
            "sgd_update": sgd_update_cuda}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
    _wrappers()["flash_attention"].mma_launches = 0


def read_counts() -> dict:
    """Launches by wrapper; ``flash_attention_mma`` counts those of
    ``flash_attention``'s launches that took the tensor-core kernel."""
    counts = {name: fn.launches for name, fn in _wrappers().items()}
    counts["flash_attention_mma"] = _wrappers()["flash_attention"].mma_launches
    return counts


# ---------------------------------------------------------------------------
# pairwise_rank: inputs, comparison, bound
# ---------------------------------------------------------------------------

# fp32 operations per valid pair (pm != 0), transcendentals (expf, log1pf,
# expm1f, the sigmoid's expf, a division) counted as one operation each
# (csrc/pairwise_rank.cu): the loss alone, and the fused loss and gradient
PAIR_OPS = {("fwd", True): 14, ("fwd", False): 16,
            ("fused", True): 18, ("fused", False): 28}


def pairwise_inputs(torch, b, n, seed, *, masked_frac=0.3, case="random"):
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    s = torch.randn(b, n, generator=g, device=dev)
    t = torch.randn(b, n, generator=g, device=dev)
    m = (torch.rand(b, n, generator=g, device=dev) > masked_frac).float()
    if case == "all-masked":
        m.zero_()
    elif case == "duplicated-scores":           # l = 0 on many pairs
        s = torch.randint(0, 3, (b, n), generator=g, device=dev).float()
    elif case == "tied-targets":                # hard target 0.5 on many pairs
        t = torch.randint(0, 3, (b, n), generator=g, device=dev).float()
    elif case == "fractional-mask":
        m[:, n // 2] = 0.5
    elif case.startswith("well-ranked-"):       # scores ordered as the targets
        s = float(case.rsplit("-", 1)[1]) * t.argsort(1).argsort(1).float()
    return s.contiguous(), t.contiguous(), m.contiguous()


def pairwise_plain(torch, s, t, m, hard):
    """Plain loss (B,) and autograd score gradient (B, N), in the inputs'
    precision; in chunks of cohorts whose (chunk, N, N) matrices hold at
    most 2^26 entries (one cohort a chunk at N = 8192)."""
    from repro_torch.kernels.pairwise_rank.ref import pairwise_rank_ref

    b, n = s.shape
    step = max(1, 2**26 // (n * n))
    rows = [slice(r, min(r + step, b)) for r in range(0, b, step)]
    losses, grads = [], []
    for r in rows:
        x = s[r].detach().clone().requires_grad_(True)
        loss = pairwise_rank_ref(x, t[r], m[r], hard)
        (grad,) = torch.autograd.grad(loss.sum(), x)
        losses.append(loss.detach())
        grads.append(grad)
    return torch.cat(losses), torch.cat(grads)


def pairwise_bound_ms(torch, m, kind, hard):
    """Least time for one call: the operations on the valid pairs this mask
    gives (pm != 0) over the fp32 rate, the type of the function's inputs
    and outputs, or the bytes (inputs read once, outputs written once) over
    HBM bandwidth, whichever is larger."""
    b, n = m.shape
    nz = (m != 0).double().sum(1)
    pairs = float((nz * nz - nz).sum())
    ops = pairs * PAIR_OPS[(kind, hard)]
    # s, t, m in; loss f32 and count f64 out; + the gradient out
    nbytes = 12.0 * b * n + 12.0 * b + (0.0 if kind == "fwd" else 4.0 * b * n)
    t_ops, t_bytes = ops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_kernel_vs_plain(torch):
    from repro_torch.kernels.select_topk import ops
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
        # the kernel's other hidden-width variants: H=20 pads to 32; F=64,
        # H=128 needs more than 48 KB of shared memory; k=1000 keeps more
        # than a tile's 256 rows per list
        dict(n=3000, f=3, h=20, k=10, seed=10, name="hidden-32"),
        dict(n=5000, f=64, h=128, k=64, seed=11, name="f64-hidden-128"),
        dict(n=100_000, f=6, k=1000, seed=12, name="k-1000"),
        dict(n=1000, f=6, k=1000, seed=13, name="k-equals-n"),
        # past the first design's caps (F <= 64, H <= 128, k <= 1024): the
        # wide scorer (weights through the read-only cache, activations in
        # a scratch) and merges of lists longer than 1024
        dict(n=5000, f=96, h=256, k=64, seed=14, name="wide-f96-h256"),
        dict(n=100_000, f=96, h=256, k=64, seed=15, name="wide-f96-h256"),
        dict(n=20_000, f=1000, h=64, k=10, seed=16, name="wide-f1000"),
        dict(n=3000, f=200, h=128, k=64, seed=17, name="smem-f200-h128"),
        dict(n=100_000, f=6, k=2000, seed=18, name="k-2000"),
        dict(n=100_000, f=6, k=5000, seed=19, masked_frac=0.97, name="k-5000"),
        dict(n=4000, f=6, k=4000, seed=20, name="k-equals-n-4000"),
        dict(n=30_000, f=96, h=256, k=2000, seed=21, dup_groups=900,
             masked_frac=0.2, exact=True, name="wide-k2000-duplicate-rows"),
        # the fleet's size with tied rows (the carried lists and the groups'
        # merges), and k at each route's K_pad boundary: 256 is the largest
        # carried list, 257 (K_pad 264) the smallest tree; at 1e5 rows
        # (128-row tiles) and 1000 (64-row tiles)
        dict(n=1_000_000, f=6, k=64, seed=22, dup_groups=5000, masked_frac=0.2,
             exact=True, name="fleet-1e6-duplicate-rows"),
        dict(n=100_000, f=6, k=256, seed=23, name="carry-k256"),
        dict(n=100_000, f=6, k=257, seed=24, name="tree-k257"),
        dict(n=1000, f=6, k=256, seed=25, name="carry-k256-n1000"),
        dict(n=1000, f=6, k=257, seed=26, masked_frac=0.5, name="tree-k257-n1000"),
        dict(n=300, f=6, k=8, seed=27, name="carry-k8"),
        # every hidden width: the widest net whose activations stay in
        # shared memory (H_pad 320) at the largest carried list, then the
        # global path (H_pad > 320: activations through the scratch), with
        # H % 4 != 0 (4-byte weight copies), the tree route and tied rows.
        # Weights at the Q-net's init scale, N(0, 1 / fan_in): at a fixed
        # 0.3 a 512-wide net's partial sums reach ~1e3, and a score near 0
        # then carries more than 1e-5 of fp32 rounding in any summation order
        dict(n=20_000, f=20, h=320, k=256, seed=28, init_scale=True, name="streamed-h320-k256"),
        dict(n=20_000, f=20, h=384, k=64, seed=29, init_scale=True, name="global-h384"),
        dict(n=5000, f=7, h=515, k=16, seed=30, init_scale=True, name="global-h515"),
        dict(n=3000, f=40, h=1024, k=300, seed=31, init_scale=True, name="global-h1024-tree"),
        dict(n=20_000, f=14, h=600, k=64, seed=32, dup_groups=700, masked_frac=0.2,
             init_scale=True, exact=True, name="global-h600-duplicate-rows"),
    ]
    max_err, summary = 0.0, []
    for c in cases:
        kw = {key: c[key] for key in ("h", "masked_frac", "zero_net",
                                      "dup_groups", "int_bias", "init_scale") if key in c}
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
    # a row's score does not depend on the route: the carried list's k = 64
    # winners are the tree's first 64, bit for bit, on each scoring path
    same_bits = []
    for n, f, h in ((1_000_000, 14, HIDDEN), (100_000, 96, 256), (20_000, 20, 512)):
        params, feats, mask, bias = topk_inputs(torch, n, f, seed=n + f, h=h,
                                                init_scale=h > 256)
        carry = select_topk_cuda(params, feats, mask, bias, k=64)
        tree = select_topk_cuda(params, feats, mask, bias, k=300)
        require(torch.equal(carry[0], tree[0][:64]) and torch.equal(carry[1], tree[1][:64]),
                f"the carry and tree routes differ at N={n}, F={f}, H={h}")
        same_bits.append([n, f, h])
    emit(phase="kernel_vs_plain", kernel="select_topk", same_bits_by_route=same_bits)
    # the op the paths call (host arrays in and out, one C call) at the main
    # path's two shapes, against the plain version on the same inputs
    for label, n, k, masked in (("op-main-probe-set", 1000, 20, 0.3),
                                ("op-main-select", 25, 25, 0.0)):
        params, states, m, bias, k = topk_op_inputs(torch, n, k, masked)
        idx, vals = ops.select_topk(params, states, m, k, bias=bias)
        ref_v, ref_i = select_topk_ref(
            params, torch.as_tensor(states, dtype=torch.float32, device="cuda"),
            torch.as_tensor(m, dtype=torch.float32, device="cuda"),
            torch.as_tensor(bias, dtype=torch.float32, device="cuda"), k=n)
        k_eff = min(k, int(m.sum()))
        err = check_topk(torch, ref_v, ref_i, torch.as_tensor(vals), torch.as_tensor(idx),
                         k_eff, False)
        max_err = max(max_err, err)
        summary.append([label, n, 6, HIDDEN, k, err])
    emit(phase="kernel_vs_plain", kernel="select_topk", cases=len(summary),
         tolerance="1e-5*max(1,|v|)", max_abs_err=max_err, results=summary)
    return max_err


def topk_op_inputs(torch, n, k, masked_frac, f=6):
    """The op's inputs at a main-path shape: a Q-net on the card, float64
    host states, a bool availability mask and a fairness bias."""
    import numpy as np

    params, _, _, _ = topk_inputs(torch, n, f, seed=n + k)
    rng = np.random.default_rng(n)
    states = rng.normal(size=(n, f))
    m = rng.random(n) >= masked_frac
    bias = -0.05 * np.sqrt(rng.integers(0, 5, n).astype(np.float64))
    return params, states, m, bias, k


# 1e6 candidates; the main path's fleet cut (probe_set, N=1000, k=20) and
# its probe-cohort ordering (select, N=25, k=25); the "telemetry" feature
# width (F=14) at 1e6; a wide net (F=96, H=256), a wider one whose
# activations go through the scratch (H=512) and k=2000 (the tree route)
TOPK_SHAPES = (("fleet_1e6", 1_000_000, 6, HIDDEN, 64),
               ("fleet_1e6_f14", 1_000_000, 14, HIDDEN, 64),
               ("main_probe_set", 1000, 6, HIDDEN, 20),
               ("main_select", 25, 6, HIDDEN, 25),
               ("wide_f96_h256", 100_000, 96, 256, 64),
               ("wide_f20_h512", 100_000, 20, 512, 64),
               ("k2000", 100_000, 6, HIDDEN, 2000))


def phase_timings(torch, card):
    """Each shape: the device wrapper (CUDA events around each call, the
    wrapper's host time included) and the plain version in turns (kernel,
    plain, plain, kernel; each side's time the median of its 50 calls, each
    turn's median in ``*_runs``), the bound and the launches a call."""
    from repro_torch.kernels.select_topk.kernel import launch_config, select_topk_cuda
    from repro_torch.kernels.select_topk.ref import select_topk_ref

    rows = {}
    for label, n, f, h, k in TOPK_SHAPES:
        params, feats, mask, bias = topk_inputs(torch, n, f, seed=n + f, h=h)
        kern = lambda: select_topk_cuda(params, feats, mask, bias, k=k)   # noqa: E731
        plain = lambda: select_topk_ref(params, feats, mask, bias, k=k)   # noqa: E731
        t = [cuda_times(torch, fn) for fn in (kern, plain, plain, kern)]
        med = statistics.median
        ms = med(t[0] + t[3])
        bound, bound_by = topk_bound_ms(n, f, h, k)
        cfg = launch_config(n, f, h, k)
        rows[label] = dict(n=n, f=f, h=h, k=k, ms=ms, ms_runs=[med(t[0]), med(t[3])],
                           plain_ms=med(t[1] + t[2]), plain_ms_runs=[med(t[1]), med(t[2])],
                           bound_ms=bound, bound_by=bound_by, kernel_vs_bound=ms / bound,
                           ms_back_to_back=cuda_ms_back_to_back(torch, kern),
                           route=cfg["route"], path=cfg["path"],
                           launches_per_call=cfg["launches"])
        emit(phase="timing", kernel="select_topk", shape=label, card=card,
             **rows[label])
    return rows


def old_topk_op(select_topk_cuda, params, states, mask, k, bias):
    """The op's Q-net path before the one-call route: six parameter copies,
    three pageable uploads, the device wrapper, two ``.cpu()`` downloads."""
    import numpy as np
    import torch

    n = states.shape[0]
    m = mask.astype(bool)
    k_eff = min(int(k), int(m.sum()))
    dev = params["w1"].device
    p = {name: t.detach().float().contiguous() for name, t in params.items()}
    feats = torch.as_tensor(np.ascontiguousarray(states, np.float32), device=dev)
    mt = torch.as_tensor(m.astype(np.float32), device=dev)
    bt = torch.as_tensor(np.ascontiguousarray(np.asarray(bias, np.float32)), device=dev)
    vals, idx = select_topk_cuda(p, feats, mt, bt, k=min(int(k), n))
    return (idx[:k_eff].cpu().numpy().astype(np.int64),
            vals[:k_eff].cpu().numpy().astype(np.float32))


def phase_topk_host(torch, card, calls=1000):
    """The op the paths call (``ops.select_topk`` with the Q-net on the
    card: one C call from pinned buffers) at the main path's two shapes,
    host included (``time.perf_counter`` over ``calls`` calls after 100 of
    warm-up), beside the sequence it replaced (:func:`old_topk_op`), in
    turns (old, new, new, old; each side's time the mean of its 2000 calls,
    each turn's mean in ``*_runs``); then the device kernels per op call, from
    ``torch.profiler`` over 20 calls."""
    import numpy as np

    from repro_torch.kernels.select_topk import ops
    from repro_torch.kernels.select_topk.kernel import select_topk_cuda

    out = {}
    for label, n, k, masked in (("main_probe_set", 1000, 20, 0.3),
                                ("main_select", 25, 25, 0.0)):
        params, states, m, bias, k = topk_op_inputs(torch, n, k, masked)
        new = lambda: ops.select_topk(params, states, m, k, bias=bias)    # noqa: E731
        old = lambda: old_topk_op(select_topk_cuda, params, states, m, k, bias)  # noqa: E731
        got, want = new(), old()
        require(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1]),
                f"{label}: the op and the old sequence disagree")
        t = []
        for fn in (old, new, new, old):
            for _ in range(100):
                fn()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            t.append(1e3 * (time.perf_counter() - t0) / calls)
        wall, rows, dev_us, _ = device_profile(torch, lambda: [new() for _ in range(20)])
        kern = [e for e in rows if "Memcpy" not in e.key and "Memset" not in e.key]
        per_call = sum(e.count for e in kern) / 20
        require(per_call == 1, f"{label}: {per_call} device kernels an op call: "
                f"{[(e.key[:60], e.count) for e in kern]}")
        out[label] = dict(n=n, k=k, calls=calls, op_ms=(t[1] + t[2]) / 2,
                          op_ms_runs=[t[1], t[2]], old_sequence_ms=(t[0] + t[3]) / 2,
                          old_sequence_ms_runs=[t[0], t[3]],
                          device_kernels_per_op_call=per_call,
                          kernel_device_us=sum(dev_us(e) for e in kern) / 20)
        emit(phase="timing", kernel="select_topk", shape=f"op_host_included_{label}",
             card=card, **out[label])
    return out


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


def phase_main_path(torch, data):
    """Path 1: synchronous rounds at 1000 devices, fedavg then cold-start
    fedrank."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy
    from repro_torch.kernels.select_topk.kernel import select_topk_cuda

    cfg = FLConfig(n_devices=1000, k_select=10, rounds=3, l_ep=5,
                   scenario="high-churn")
    reset_counts()                                # every count to 0
    per_policy = {}
    for name in ("fedavg", "fedrank"):
        srv = FLServer(cfg, MLPTask(), data, device="cuda")
        policy = build_policy(name, k=10) if name == "fedrank" else build_policy(name)
        launched = []
        for _ in range(cfg.rounds):
            before = select_topk_cuda.launches
            res = srv.run_round(policy)
            launched.append(select_topk_cuda.launches - before)
            check_round(srv, res, cfg.k_select)
            emit(phase="main", policy=name, round=res.round, acc=res.acc,
                 test_loss=res.test_loss, r_t=res.r_t, r_e=res.r_e,
                 cohort=res.selected.tolist(), probe=len(res.probe_set),
                 failed=res.failed.tolist(), host_s=res.host_time_s,
                 select_topk_launches=launched[-1])
        for key, t in srv.global_params.items():
            require(t.is_cuda and bool(torch.isfinite(t).all()), key)
        per_policy[name] = launched
    counts = read_counts()                        # read just after
    require(all(n >= 2 for n in per_policy["fedrank"]), per_policy)
    require(counts["select_topk"] > 0, counts)
    emit(phase="main_launches", path="sync_rounds", launches=counts,
         per_round=per_policy)
    return counts, srv, policy


def check_round(srv, res, k):
    """A round's cohort is unique, at most k, online; its outcome finite."""
    online = srv.pool.available()
    sel = res.selected.tolist()
    require(len(sel) == len(set(sel)) <= k, sel)
    require(bool(online[res.selected].all()), "offline device selected")
    require(math.isfinite(res.acc) and math.isfinite(res.test_loss))


def phase_profile(torch, srv, policy):
    """One more FedRank round under torch.profiler: where the round's time
    goes on the card.  The profiler slows the host, so the wall time here
    is longer than an unprofiled round's (the main-path lines give those)."""
    res = []
    wall, rows, dev_us, _ = device_profile(
        torch, lambda: res.append(srv.run_round(policy)))
    busy_s = sum(dev_us(e) for e in rows) / 1e6
    sel_s = sum(dev_us(e) for e in rows
                if "select_topk_fused" in e.key or "merge_pairs" in e.key) / 1e6
    top = sorted(rows, key=dev_us, reverse=True)[:8]
    emit(phase="profile", policy=policy.name, round=res[0].round, wall_s=wall,
         device_kernels=sum(e.count for e in rows), device_busy_s=busy_s,
         device_idle_share=(1.0 - busy_s / wall) if busy_s else "not measured",
         select_topk_device_s=sel_s,
         top_device_ms=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])


def check_pairwise(torch, c, loss, grad, ref_loss, ref_grad):
    """Loss and gradient (either may be None) against the fp64 plain
    version; returns (loss error, gradient error).  A well-ranked cohort's
    loss with hard targets is held to 1e-5 of itself as well."""
    e_loss = e_grad = 0.0
    if loss is not None:
        err = (loss.detach().double() - ref_loss).abs()
        require(bool((err <= TOL * torch.clamp(ref_loss.abs(), min=1.0)).all()),
                f"pairwise loss off in {c}: {err.max().item()}")
        if c["case"].startswith("well-ranked-") and c["hard"]:
            rel = float((err / ref_loss.abs()).max())
            require(bool((ref_loss > 0).all()) and rel <= TOL,
                    f"pairwise loss off relative in {c}: {rel}")
        if c["case"] == "all-masked":
            require(bool((loss == 0).all()), c)
        e_loss = float(err.max())
    if grad is not None:
        g_ref_max = ref_grad.abs().max(1).values
        err = (grad.double() - ref_grad).abs().max(1).values
        require(bool((err <= TOL * g_ref_max).all()),
                f"pairwise gradient off in {c}: {err.max().item()}")
        if c["case"] == "all-masked":
            require(not bool(grad.any()), c)
        e_grad = float(err.max())
    return e_loss, e_grad


def phase_pairwise_vs_plain(torch):
    """Each route against the plain version and its autograd: the op with a
    gradient (the fused launch, through its autograd Function) and the op
    under ``torch.no_grad`` (the loss-only launch)."""
    from repro_torch.kernels.pairwise_rank.kernel import (
        pairwise_rank_fused_cuda,
        pairwise_rank_fwd_cuda,
    )
    from repro_torch.kernels.pairwise_rank.ops import pairwise_rank

    cases = [dict(b=b, n=n, hard=hard, case="random")
             for n in (1, 2, 7, 30, 31, 32, 33, 127, 128, 129, 1000, 8192)
             for b in (1, 16) for hard in (True, False)]
    # past grid.y's 65,535 rows (the tile kernel loops over cohort chunks;
    # N = 8 takes four cohorts a warp)
    cases += [dict(b=70_000, n=n, hard=hard, case="random")
              for n in (8, 40) for hard in (True, False)]
    for hard in (True, False):
        cases += [dict(b=16, n=30, hard=hard, case="all-masked"),
                  dict(b=16, n=129, hard=hard, case="all-masked"),
                  dict(b=16, n=129, hard=hard, case="duplicated-scores"),
                  dict(b=16, n=30, hard=hard, case="duplicated-scores"),
                  dict(b=4, n=1000, hard=hard, case="tied-targets"),
                  dict(b=16, n=30, hard=hard, case="tied-targets"),
                  dict(b=16, n=30, hard=hard, case="fractional-mask"),
                  dict(b=16, n=300, hard=hard, case="fractional-mask")]
    # well-ranked cohorts: losses from ~1e-2 down to ~1e-9, held relative
    cases += [dict(b=b, n=n, hard=True, case=f"well-ranked-{gap:g}")
              for gap in (4.0, 10.0, 20.0) for b, n in ((16, 30), (4, 1000))]
    errs = {"fused_loss": 0.0, "fused_grad": 0.0, "fwd_loss": 0.0}
    summary = []
    for i, c in enumerate(cases):
        s, t, m = pairwise_inputs(torch, c["b"], c["n"], seed=i, case=c["case"])
        x = s.clone().requires_grad_(True)
        loss = pairwise_rank(x, t, m, hard=c["hard"])
        (grad,) = torch.autograd.grad(loss.sum(), x)
        with torch.no_grad():
            loss_only = pairwise_rank(x, t, m, hard=c["hard"])
        _, count_f, grad_f = pairwise_rank_fused_cuda(s, t, m, hard=c["hard"])
        _, count_w = pairwise_rank_fwd_cuda(s, t, m, hard=c["hard"])
        ref_loss, ref_grad = pairwise_plain(torch, s.double(), t.double(),
                                            m.double(), c["hard"])
        torch.cuda.synchronize()
        ref_loss, ref_grad = ref_loss.double(), ref_grad.double()
        md = m.double()
        count = md.sum(1) ** 2 - (md * md).sum(1)      # sum of m_i m_j over i != j
        require(torch.equal(count_f, count) and torch.equal(count_w, count),
                f"pair counts off in {c}")
        require(torch.equal(grad_f, grad), f"autograd's gradient is not the saved one in {c}")
        e = {}
        e["fused_loss"], e["fused_grad"] = check_pairwise(torch, c, loss, grad, ref_loss, ref_grad)
        e["fwd_loss"], _ = check_pairwise(torch, c, loss_only, None, ref_loss, ref_grad)
        for key, val in e.items():
            errs[key] = max(errs[key], val)
        summary.append([c["case"], c["b"], c["n"], "hard" if c["hard"] else "soft"]
                       + [e[k] for k in errs] + [float(ref_loss.abs().min()),
                                                 float(ref_grad.abs().max())])
    emit(phase="kernel_vs_plain", kernel="pairwise_rank", cases=len(cases),
         tolerance={"loss": "1e-5*max(1,|loss|); well-ranked hard cohorts also "
                            "1e-5*|loss|",
                    "gradient": "1e-5*max|g_ref| of its row"},
         max_abs_err_fused_loss=errs["fused_loss"],
         max_abs_err_fused_grad=errs["fused_grad"],
         max_abs_err_fwd_loss=errs["fwd_loss"],
         results=[["case", "B", "N", "targets", *errs, "min|loss_ref|", "max|g_ref|"]]
         + summary)
    return errs


def phase_pairwise_timings(torch, card):
    """At the IL shape (B=16 cohorts of 30, hard targets) and three large
    ones: the fused launch (loss and gradient) and the loss-only launch,
    the plain version beside them (its gradient is its forward plus
    autograd), except at 65,536 where its N^2 matrices do not fit.  The
    design the fused launch replaced (a loss launch, then a gradient
    launch) is timed from a checkout of it by
    ``scripts/pairwise_rank_precision.py``."""
    from repro_torch.kernels.pairwise_rank.kernel import (
        pairwise_rank_fused_cuda,
        pairwise_rank_fwd_cuda,
    )
    from repro_torch.kernels.pairwise_rank.ref import pairwise_rank_ref

    rows = {}
    for label, b, n in (("il_b16_n30", 16, 30), ("b1_n8192", 1, 8192),
                        ("b1_n65536", 1, 65536), ("b70000_n8", 70_000, 8)):
        s, t, m = pairwise_inputs(torch, b, n, seed=b + n, masked_frac=0.0)
        routes = {"fused": (lambda: pairwise_rank_fused_cuda(s, t, m, hard=True),
                            lambda: pairwise_plain(torch, s, t, m, True)),
                  "fwd": (lambda: pairwise_rank_fwd_cuda(s, t, m, hard=True),
                          lambda: pairwise_rank_ref(s, t, m, True))}
        out = {}
        for kind, (fn, plain) in routes.items():
            bound, bound_by = pairwise_bound_ms(torch, m, kind, True)
            out[kind] = dict(b=b, n=n, hard=True, ms=cuda_ms(torch, fn),
                             plain_ms=cuda_ms(torch, plain) if n <= 8192 else None,
                             bound_ms=bound, bound_by=bound_by, library_ms=None)
            if label == "il_b16_n30":      # launch-bound: where the host's time goes
                out[kind]["host_us"] = host_us(torch, fn)
            emit(phase="timing", kernel=f"pairwise_rank_{kind}", shape=label,
                 card=card, **out[kind])
        if label == "il_b16_n30":
            out["host_us_torch_empty_x3"] = host_us(torch, lambda: (
                torch.empty(b, device="cuda"),
                torch.empty(b, dtype=torch.float64, device="cuda"),
                torch.empty((b, n), device="cuda")))
            emit(phase="timing", kernel="torch_empty_x3", shape=label, card=card,
                 host_us=out["host_us_torch_empty_x3"])
        rows[label] = out
    return rows


def phase_cpu_agreement_policies(torch, data):
    """One round of every policy this slice adds, at 50 devices, on the CPU
    and on the card from the same seeds: the same probe sets and cohorts.
    ``favor`` starts from one Q-net (made on the CPU, copied) with eps=0, so
    its cut is the fused scoring + top-K on both."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy

    for name in ("afl", "tifl", "oort", "oort-telemetry", "favor", "fedmarl",
                 "expert-oort", "expert-harmony", "expert-fedmarl"):
        results, q0 = {}, None
        for dev in ("cpu", "cuda"):
            cfg = FLConfig(n_devices=50, k_select=5, rounds=1, l_ep=2,
                           scenario="high-churn", seed=3)
            srv = FLServer(cfg, MLPTask(), data, device=dev)
            if name == "favor":
                pol = build_policy("favor", eps=0.0, device=dev)
                if q0 is None:
                    q0 = pol.q
                pol.q = {k: v.to(dev) for k, v in q0.items()}
                pol.q_target = {k: v.to(dev) for k, v in q0.items()}
            else:
                pol = build_policy(name)
            results[dev] = srv.run_round(pol)
        a, b = results["cpu"], results["cuda"]
        require(a.probe_set.tolist() == b.probe_set.tolist(), (name, a.probe_set, b.probe_set))
        require(a.selected.tolist() == b.selected.tolist(), (name, a.selected, b.selected))
        emit(phase="cpu_vs_card", policy=name, cohort=b.selected.tolist(),
             probe=len(b.probe_set), acc_cpu=a.acc, acc_card=b.acc)


def phase_cpu_agreement_il(torch):
    """5 pretraining steps from the same demonstrations and Q-net (made on
    the CPU, copied) on each device.  Params within 1e-4: the gradients
    agree to fp32 rounding and Adam amplifies that over steps.  ``b3`` is
    held only to move at most lr per step: the pairwise loss ignores a shift
    of every score, so its gradient is rounding noise that Adam normalises."""
    from repro_torch.core import augment_demonstrations, init_qnet, pretrain_qnet

    demos = augment_demonstrations([], n_synthetic=40, seed=0)
    q0 = init_qnet(0, device="cpu")
    out = {dev: pretrain_qnet(demos, steps=5, batch=16, lr=1e-3, qnet_params=q0,
                              device=dev) for dev in ("cpu", "cuda")}
    (qa, ha), (qb, hb) = out["cpu"], out["cuda"]
    worst = 0.0
    for k in qa:
        err = float((qa[k] - qb[k].cpu()).abs().max())
        if k == "b3":
            for q in (qa, qb):
                require(float((q[k].cpu() - q0[k]).abs().max()) <= 5e-3 * (1 + 1e-6), k)
            continue
        require(err <= 1e-4, (k, err))
        worst = max(worst, err)
    require(all(abs(x - y) <= 1e-4 for x, y in zip(ha["loss"], hb["loss"])), (ha, hb))
    emit(phase="cpu_vs_card", path="pretrain_qnet", steps=5, max_param_err=worst,
         loss_cpu=ha["loss"], loss_card=hb["loss"], tolerance=1e-4)


def phase_il_path(torch, data):
    """Path 2: imitation learning at the paper's configuration, then FedRank
    rounds from the pretrained Q-net."""
    from repro_torch.core import augment_demonstrations, collect_demonstrations, pretrain_qnet
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy

    cfg = FLConfig(n_devices=1000, k_select=10, rounds=3, l_ep=5,
                   scenario="high-churn")
    servers = []

    def make_server():
        servers.append(FLServer(cfg, MLPTask(), data, device="cuda"))
        return servers[-1]

    reset_counts()                                # every count to 0
    stages = {}
    t0 = time.perf_counter()
    demos = collect_demonstrations(make_server, ("oort", "harmony", "fedmarl"),
                                   rounds_per_expert=15)
    torch.cuda.synchronize()
    stages["collect_s"] = time.perf_counter() - t0
    for srv in servers:
        for res in srv.history:
            sel = res.selected.tolist()
            require(len(sel) == len(set(sel)) <= cfg.k_select, sel)
            require(set(sel) <= set(res.probe_set.tolist()), "outside probe set")
    t0 = time.perf_counter()
    demos = augment_demonstrations(demos, n_synthetic=200)
    stages["augment_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    q, hist = pretrain_qnet(demos, steps=2000, batch=16, lr=1e-3)
    torch.cuda.synchronize()
    stages["pretrain_s"] = time.perf_counter() - t0
    pre_counts = read_counts()
    # one pair-kernel launch a step: the fused loss and gradient
    require(pre_counts["pairwise_rank_fused"] == 2000, pre_counts)
    require(pre_counts["pairwise_rank_fwd"] == 0, pre_counts)
    pair_per_step = sum(pre_counts[k] for k in ("pairwise_rank_fused",
                                                "pairwise_rank_fwd")) / 2000
    require(hist["rank_acc"][-1] > hist["rank_acc"][0], hist["rank_acc"])
    for key, t in q.items():
        require(t.is_cuda and bool(torch.isfinite(t).all()), key)
    t0 = time.perf_counter()
    srv = FLServer(cfg, MLPTask(), data, device="cuda")
    policy = build_policy("fedrank", qnet=q, k=10)
    for _ in range(cfg.rounds):
        res = srv.run_round(policy)
        check_round(srv, res, cfg.k_select)
        emit(phase="il_fedrank", round=res.round, acc=res.acc,
             test_loss=res.test_loss, cohort=res.selected.tolist(),
             host_s=res.host_time_s)
    torch.cuda.synchronize()
    stages["fedrank_rounds_s"] = time.perf_counter() - t0
    counts = read_counts()                        # read just after
    require(counts["select_topk"] >= 2 * cfg.rounds, counts)
    emit(phase="il_path", demos=len(demos), recorded=len(demos) - 200,
         max_cohort=max(len(d.states) for d in demos), steps=2000, batch=16,
         hist=hist, seconds=stages, launches=counts,
         pretrain_launches=pre_counts, pair_kernel_launches_per_step=pair_per_step)
    return counts, demos, q


def phase_baselines(torch, data):
    """Path 3: one round of each baseline at 1000 devices.  ``favor`` runs
    greedy (eps=0), so its fleet cut is the select_topk kernel."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy

    cfg = FLConfig(n_devices=1000, k_select=10, rounds=1, l_ep=5,
                   scenario="high-churn")
    reset_counts()
    for name in ("afl", "tifl", "oort", "oort-telemetry", "favor", "fedmarl"):
        srv = FLServer(cfg, MLPTask(), data, device="cuda")
        pol = build_policy(name, eps=0.0) if name == "favor" else build_policy(name)
        res = srv.run_round(pol)
        check_round(srv, res, cfg.k_select)
        emit(phase="baseline", policy=name, acc=res.acc, cohort=res.selected.tolist(),
             probe=len(res.probe_set), host_s=res.host_time_s)
    counts = read_counts()
    require(counts["select_topk"] >= 1, counts)
    emit(phase="baseline_launches", path="baselines", launches=counts)


def device_profile(torch, fn):
    """Run fn under torch.profiler: (wall s, CUDA rows, device-time getter,
    all rows)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    rows = [e for e in averages if e.device_type == DeviceType.CUDA]
    return wall, rows, lambda e: getattr(e, "self_device_time_total", 0.0), averages


def kernel_times(rows, dev_us, part):
    """{kernel name: [device ms, launches]} over the profiled kernels whose
    name contains ``part`` (``flash_fwd`` matches both flash kernels)."""
    out = {}
    for e in rows:
        m = re.search(r"\w*%s\w*" % re.escape(part), e.key)
        if m:
            ms, n = out.get(m.group(0), (0.0, 0))
            out[m.group(0)] = [ms + dev_us(e) / 1e3, n + e.count]
    return out


def phase_il_profile(torch, demos, q):
    """50 pretraining steps under torch.profiler.  The call also pads and
    featurizes the demonstrations on the host; a 0-step call, unprofiled,
    gives that set-up time apart."""
    from repro_torch.core import pretrain_qnet

    t0 = time.perf_counter()
    pretrain_qnet(demos, steps=0, qnet_params=q)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    wall, rows, dev_us, averages = device_profile(
        torch, lambda: pretrain_qnet(demos, steps=50, batch=16, qnet_params=q))
    busy_s = sum(dev_us(e) for e in rows) / 1e6
    pair_s = sum(dev_us(e) for e in rows if "pairwise_rank" in e.key) / 1e6
    top = sorted(rows, key=dev_us, reverse=True)[:8]
    # where the host's time goes: torch ops by their own CPU time (the rest
    # of the wall time is Python between them)
    host = sorted((e for e in averages if e.self_cpu_time_total > 0),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    host_op_s = sum(e.self_cpu_time_total for e in host) / 1e6
    emit(phase="profile", path="pretrain_qnet", steps=50, wall_s=wall,
         setup_s_unprofiled=setup, device_kernels=sum(e.count for e in rows),
         device_busy_s=busy_s,
         device_idle_share=(1.0 - busy_s / wall) if busy_s else "not measured",
         pairwise_rank_device_s=pair_s,
         pairwise_rank_share_of_busy=(pair_s / busy_s) if busy_s else "not measured",
         top_device_ms=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top],
         host_op_s=host_op_s,
         top_host_ms=[[e.key[:50], e.self_cpu_time_total / 1e3, e.count]
                      for e in host[:12]])


# ---------------------------------------------------------------------------
# fleet_state: inputs, comparison, bound
# ---------------------------------------------------------------------------

DAY_S = 86400.0
WEEK_S = 7 * DAY_S


def fleet_args(torch, tr, src, t):
    """The kernel's inputs for source devices ``src`` at absolute times
    ``t``: the trace's resident segment table and the packed query records
    on the card."""
    import numpy as np

    from repro_torch.kernels.fleet_state.ops import _split_times, pack_queries

    segs = tr.resident("cuda")
    require(np.array_equal(segs.offsets.cpu().numpy(), tr.offsets),
            "uploaded offsets differ from the trace's")
    qi, qf = _split_times(np.asarray(t, np.float64) % tr.period_s)
    q = pack_queries(np.asarray(src).astype(np.int32), qi, qf)
    return segs, torch.as_tensor(q, device="cuda")


def fleet_plain(args):
    """The plain version on the kernel's inputs (the table's column views
    and the records' columns)."""
    import torch

    from repro_torch.kernels.fleet_state.ref import segment_index_ref

    segs, q = args
    return segment_index_ref(segs.dev, segs.ti, segs.tf, q[:, 0], q[:, 1],
                             q[:, 2].view(torch.float32))


def fleet_args_resampled(torch, tr, n, seed, t_s):
    fleet = tr.resample(n, seed=seed, device="cuda")
    return fleet_args(torch, tr, fleet.src, t_s + fleet.phase_s)


def edge_queries(tr, rng, n_extra=2000):
    """Every segment start, +-1 s and +-eps around it, fractions that round
    to 1.0 in f32, the period's last second, random times, and padding
    (src = -1) and past-the-last devices."""
    import numpy as np

    src, t = [], []
    for d in range(tr.n_devices):
        starts, _ = tr.segments_of(d)
        for s0 in starts:
            for dt in (0.0, -1.0, 1.0, -1e-6, 1e-6, 0.99999999, -1e-8):
                src.append(d)
                t.append(s0 + dt)
        src += [d, d, d]
        t += [tr.period_s - 1e-9, tr.period_s - 1.0, 5.99999999]
    src += list(rng.integers(0, tr.n_devices, size=n_extra))
    t += list(rng.uniform(0.0, 3 * tr.period_s, size=n_extra))
    src += [-1, -1, tr.n_devices, tr.n_devices + 5]
    t += [0.0, 100.0, 0.0, 7.5]
    return np.asarray(src, np.int64), np.asarray(t, np.float64)


def random_events(rng, n_dev, max_segs, period, fractional=False, one_seg=0):
    events = {}
    for d in range(n_dev):
        k = 1 if d < one_seg else int(rng.integers(1, max_segs + 1))
        t = rng.choice(int(period), size=k, replace=False).astype(float)
        if fractional:
            t = t + (rng.random(k) * (t > 0)).round(4)
        events[f"d{d:04d}"] = [(float(x), int(rng.integers(0, 4))) for x in t]
    return events


def fleet_bound_ms(n, s, d):
    """Least time for one call: the bytes (src, qi, qf in and idx out per
    query, the three segment arrays) over HBM bandwidth, or the search's
    operations (ceil(log2(S / D + 1)) probes within the query's device, of
    ~8 compares and selects each) over the fp32 rate, whichever is larger."""
    nbytes = 16.0 * n + 12.0 * s
    ops = 8.0 * n * math.ceil(math.log2(s / d + 1))
    t_ops, t_bytes = ops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def large_trace():
    """A 1024-device four-week synthetic trace: the large-S timing case."""
    from repro_torch.fl.traces import SyntheticTraceSpec, synthesize_trace

    return synthesize_trace(SyntheticTraceSpec(n_devices=1024, days=28, seed=0))


def phase_fleet_state_vs_plain(torch, big):
    """The kernel against its plain version, exactly equal, on: both trace
    fixtures at fleet sizes 1 to 1e6 and four trace times; the edge cases
    on a week-scale trace with one-segment devices; random traces with
    whole-second and fractional starts; the 1024-device four-week trace at
    1e5 queries."""
    import numpy as np

    from repro_torch.fl.traces import (
        SyntheticTraceSpec,
        compile_events,
        read_trace_csv,
        sample_trace_path,
        synthesize_trace,
    )
    from repro_torch.kernels.fleet_state.kernel import segment_index_cuda, segment_index_lookup

    week = synthesize_trace(SyntheticTraceSpec(n_devices=32, days=7, seed=11))
    livelab = read_trace_csv(sample_trace_path())
    rng = np.random.default_rng(0)
    cases = []
    for name, tr in (("synthetic-week", week), ("livelab", livelab)):
        for n in (1, 7, 1000, 100_000, 1_000_000):
            for t_s in (0.0, 5 * 3600.0, tr.period_s - 1.0, 2.5 * tr.period_s):
                cases.append((f"{name}-fleet", tr, fleet_args_resampled(
                    torch, tr, n, n % 97, t_s)))
    edge = compile_events(random_events(rng, 40, 60, WEEK_S, one_seg=5), WEEK_S)
    for name, tr in (("edge-week", edge), ("edge-synthetic-week", week),
                     ("edge-livelab", livelab)):
        cases.append((name, tr, fleet_args(torch, tr, *edge_queries(tr, rng))))
    for i, (n_dev, max_segs, period, frac) in enumerate((
            (1, 1, DAY_S, False), (3, 200, DAY_S, True), (100, 30, 3 * DAY_S, False),
            (500, 80, WEEK_S, True), (2000, 5, 30 * DAY_S, False))):
        tr = compile_events(random_events(rng, n_dev, max_segs, period, frac), period)
        src, t = edge_queries(tr, rng, n_extra=50_000)
        cases.append((f"random-{i}", tr, fleet_args(torch, tr, src, t)))
    # the plain version's chunked count costs N * S compares: 1e5 queries
    # here (3e10), the kernel alone is timed at 1e6
    cases.append(("large-1024dev-28d", big, fleet_args_resampled(
        torch, big, 100_000, 3, 1.5 * DAY_S)))
    summary = []
    for name, tr, args in cases:
        got = segment_index_cuda(*args)
        want = fleet_plain(args)
        torch.cuda.synchronize()
        require(got.dtype == torch.int32 and bool(torch.equal(got, want)),
                f"fleet_state differs from its plain version on {name}: "
                f"{int((got != want).sum())} of {len(want)}")
        # the host path: pinned upload, launch, pinned download, one call
        q = args[1].cpu().numpy()
        host = segment_index_lookup(args[0], q[:, 0], q[:, 1], q[:, 2].view(np.float32))
        require(host.dtype == np.int32 and np.array_equal(host, want.cpu().numpy()),
                f"fleet_state's host lookup differs from its plain version on {name}")
        summary.append([name, tr.n_segments, int(args[1].shape[0])])
    emit(phase="kernel_vs_plain", kernel="fleet_state", cases=len(cases),
         tolerance="exact", max_abs_err=0, large_trace_segments=big.n_segments,
         results=[["case", "S", "N"]] + summary)
    return 0.0


def phase_fleet_state_timings(torch, card, big):
    """The kernel at the smoke fleet's lookup (1000 devices) on both trace
    fixtures and at 1e6 queries on the synthetic week and on the large
    trace, beside its plain version, its bound and ``torch.searchsorted``
    over the f64 key ``dev * period + t_start`` (the reference's host path
    in one call; timed here, used nowhere in the port)."""
    import numpy as np

    from repro_torch.fl.traces import (
        SyntheticTraceSpec,
        read_trace_csv,
        sample_trace_path,
        synthesize_trace,
    )
    from repro_torch.kernels.fleet_state.kernel import segment_index_cuda

    week = synthesize_trace(SyntheticTraceSpec(n_devices=32, days=7, seed=11))
    livelab = read_trace_csv(sample_trace_path())
    rows = {}
    for label, tr, n in (("main_week", week, 1000), ("main_livelab", livelab, 1000),
                         ("week_1e6", week, 1_000_000), ("large_1e6", big, 1_000_000)):
        fleet = tr.resample(n, seed=1, device="cuda")
        t = 5 * 3600.0 + fleet.phase_s
        args = fleet_args(torch, tr, fleet.src, t)
        dev = torch.device("cuda")
        seg_key = torch.as_tensor(tr._seg_dev * tr.period_s + tr.t_start, device=dev)
        q_key = torch.as_tensor(fleet.src * tr.period_s + t % tr.period_s, device=dev)
        lib_idx = torch.searchsorted(seg_key, q_key, right=True) - 1
        got = segment_index_cuda(*args)
        torch.cuda.synchronize()
        # the plain count at 1e6 x 3e5 segments is 3e11 compares: not timed
        small = n * tr.n_segments <= 1e10
        rows[label] = dict(
            n=n, s=tr.n_segments, d=tr.n_devices,
            ms=cuda_ms(torch, lambda: segment_index_cuda(*args)),
            plain_ms=(cuda_ms(torch, lambda: fleet_plain(args))
                      if small else None),
            library_ms=cuda_ms(torch, lambda: torch.searchsorted(
                seg_key, q_key, right=True)),
            library_agrees=bool(torch.equal(lib_idx.int(), got)))
        rows[label]["kernel_vs_library"] = rows[label]["ms"] / rows[label]["library_ms"]
        rows[label]["bound_ms"], rows[label]["bound_by"] = fleet_bound_ms(
            n, tr.n_segments, tr.n_devices)
        emit(phase="timing", kernel="fleet_state", shape=label, card=card,
             **rows[label])
    return rows


def phase_fleet_state_host(torch, card, calls=1000):
    """The op-level lookup the trace layer makes every round
    (``ops.segment_index``: wrap and split on the host, one upload, the
    launch, one download, one synchronise) at the smoke fleet's 1000
    devices on the synthetic week, host included (``time.perf_counter``
    over ``calls`` calls after 100 of warm-up), beside the reference's host
    path: numpy's ``searchsorted`` over the f64 key ``dev * period + t``
    (computed here with numpy alone)."""
    import numpy as np

    from repro_torch.fl.traces import SyntheticTraceSpec, synthesize_trace
    from repro_torch.kernels.fleet_state import ops

    tr = synthesize_trace(SyntheticTraceSpec(n_devices=32, days=7, seed=11))
    fleet = tr.resample(1000, seed=1, device="cuda")
    t = 5 * 3600.0 + fleet.phase_s
    segs = tr.resident("cuda")
    key = tr._seg_dev * tr.period_s + tr.t_start

    def op():
        return ops.segment_index(segs, tr.period_s, fleet.src, t)

    def numpy_path():
        return np.searchsorted(key, fleet.src * tr.period_s + t % tr.period_s,
                               side="right") - 1

    out = {}
    for name, fn in (("op", op), ("numpy_searchsorted", numpy_path)):
        for _ in range(100):
            fn()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out[f"{name}_ms"] = 1e3 * (time.perf_counter() - t0) / calls
    require(np.array_equal(op(), numpy_path()), "op and numpy searchsorted disagree")
    emit(phase="timing", kernel="fleet_state", shape="op_host_included_n1000", card=card,
         n=1000, s=tr.n_segments, calls=calls, **out)
    return out


def check_async_history(torch, srv, hist, k):
    """Each aggregation merges unique devices, at most k of them, with a
    finite outcome; the virtual clock never runs backwards."""
    last = -1.0
    for res in hist:
        sel = res.selected.tolist()
        require(len(sel) == len(set(sel)) <= k, sel)
        require(math.isfinite(res.acc) and math.isfinite(res.test_loss))
        require(res.cum_time >= last, (res.cum_time, last))
        last = res.cum_time
    for key, t in srv.global_params.items():
        require(t.is_cuda and bool(torch.isfinite(t).all()), key)


def record_jobs(engine):
    """Log every job an async engine schedules: (device, version, dispatch
    order, wave, duration, energy, dropout point, probe-only)."""
    log = []
    add = engine._add_job

    def recording_add(cid, **kw):
        log.append((int(cid), engine.version, engine._seq, engine.cycle,
                    kw["duration"], kw["energy"], kw["fail_at"],
                    kw["params"] is None))
        add(cid, **kw)

    engine._add_job = recording_add
    return log


def start_before_first_change(srv):
    """Fast-forward a trace scenario's pool so that the first round driven
    next (a sync round, or an async engine's start) is the last one before
    the fleet's first availability change, found by ``next_transition`` (on
    the card, fleet_state lookups): trace-synthetic-week keeps every device
    online for its first hours, so a run from hour 0 would never see one go
    offline.  Returns the number of devices online until that change."""
    first = srv.pool.next_transition()
    require(first is not None and first >= 2, ("no availability change", first))
    srv.pool.advance_to(first - 2)        # driving advances one round first
    return int(srv.pool.available().sum())


def require_transitions(hist, n_start, n_devices, what):
    """Some round or aggregation saw devices offline, and a different number
    online than before the fleet's first change: the clock went through a
    verified transition."""
    seen = [r.n_available for r in hist]
    require(min(seen) < n_devices and any(n != n_start for n in seen),
            (what, "no availability change seen", n_start, seen))


def phase_cpu_agreement_async(torch):
    """An asynchronous fedavg run on trace-synthetic-week at 50 devices on
    the CPU and on the card, from the same seeds: the same jobs at the same
    virtual times, the same cohorts, outcomes close.  On the card every
    availability lookup is the fleet_state kernel."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy
    from repro_torch.fl.async_engine import AsyncRoundEngine

    data = small_data(4000, 50)
    runs = {}
    for dev in ("cpu", "cuda"):
        cfg = FLConfig(n_devices=50, k_select=5, rounds=3, l_ep=2, seed=3,
                       scenario="trace-synthetic-week", mode="async",
                       async_concurrency=15, staleness="polynomial")
        srv = FLServer(cfg, MLPTask(), data, device=dev)
        start_before_first_change(srv)
        eng = AsyncRoundEngine(srv, build_policy("fedavg"))
        log = record_jobs(eng)
        runs[dev] = (log, eng.run(3))
    (la, ha), (lb, hb) = runs["cpu"], runs["cuda"]
    require(la == lb, "the CPU and the card scheduled different jobs")
    for a, b in zip(ha, hb):
        require(a.selected.tolist() == b.selected.tolist(), (a.selected, b.selected))
        require((a.cum_time, a.cum_energy) == (b.cum_time, b.cum_energy))
        require(a.n_available == b.n_available, (a.n_available, b.n_available))
        require(abs(a.acc - b.acc) <= 2e-3 and abs(a.test_loss - b.test_loss) <= 1e-3)
    emit(phase="cpu_vs_card", path="async_trace", jobs=len(lb),
         cum_time=[r.cum_time for r in hb], n_available=[r.n_available for r in hb],
         acc_cpu=[r.acc for r in ha],
         acc_card=[r.acc for r in hb])


def phase_trace_path(torch, data):
    """Path 4: synchronous rounds replaying trace-synthetic-week at 1000
    devices from the hour before its fleet's first availability change:
    every round's loads and mask are fleet_state lookups, and devices go
    offline."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy

    cfg = FLConfig(n_devices=1000, k_select=10, rounds=3, l_ep=5,
                   scenario="trace-synthetic-week")
    reset_counts()                                # every count to 0
    for name in ("fedavg", "fedrank"):
        srv = FLServer(cfg, MLPTask(), data, device="cuda")
        policy = build_policy(name, k=10) if name == "fedrank" else build_policy(name)
        n_start = start_before_first_change(srv)
        hist = []
        for _ in range(cfg.rounds):
            res = srv.run_round(policy)
            check_round(srv, res, cfg.k_select)
            hist.append(res)
            emit(phase="trace_sync", policy=name, round=res.round,
                 trace_hour=srv.pool.round_idx, acc=res.acc,
                 n_available=res.n_available, r_t=res.r_t,
                 cohort=res.selected.tolist(), host_s=res.host_time_s)
        require_transitions(hist, n_start, cfg.n_devices, f"trace_sync/{name}")
    counts = read_counts()                        # read just after
    require(counts["fleet_state"] > 0 and counts["select_topk"] >= 2 * cfg.rounds,
            counts)
    emit(phase="trace_sync_launches", path="trace_sync", launches=counts)
    return counts


def phase_async_path(torch, data):
    """Path 5: the asynchronous engine through ``FLServer.run`` with the
    example's async settings; counts reset before and read after each run."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy

    per_run, keep = {}, None
    for name, scenario in (("fedavg", "trace-synthetic-week"),
                           ("fedrank", "trace-synthetic-week"),
                           ("fedrank", "high-churn")):
        cfg = FLConfig(n_devices=1000, k_select=10, rounds=5, l_ep=5,
                       scenario=scenario, mode="async", async_concurrency=30,
                       staleness="polynomial")
        srv = FLServer(cfg, MLPTask(), data, device="cuda")
        policy = build_policy(name, k=10) if name == "fedrank" else build_policy(name)
        trace = scenario.startswith("trace")
        n_start = start_before_first_change(srv) if trace else None
        reset_counts()                            # every count to 0
        t0 = time.perf_counter()
        hist = srv.run(policy)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts()                    # read just after
        check_async_history(torch, srv, hist, cfg.k_select)
        for res in hist:
            emit(phase="async", policy=name, scenario=scenario, agg=res.round,
                 version=res.round + 1, acc=res.acc, t_virtual_s=res.cum_time,
                 r_t=res.r_t, mean_staleness=res.mean_staleness,
                 max_staleness=res.max_staleness, pending=res.n_pending,
                 n_available=res.n_available, cohort=res.selected.tolist(),
                 host_s=res.host_time_s)
        if trace:
            require_transitions(hist, n_start, cfg.n_devices, f"async/{name}")
        require((counts["fleet_state"] > 0) == trace, (scenario, counts))
        require(name != "fedrank" or counts["select_topk"] > 0, counts)
        key = f"{name}/{scenario}"
        per_run[key] = dict(launches=counts, seconds=seconds,
                            host_s_per_aggregation=[r.host_time_s for r in hist],
                            t_virtual_s=hist[-1].cum_time,
                            trace_hours=srv.pool.round_idx,
                            n_available=[r.n_available for r in hist])
        emit(phase="async_launches", path="async", run=key, **per_run[key])
        if name == "fedrank" and trace:
            keep = (srv, policy)
    return per_run, keep


def phase_async_profile(torch, srv, policy):
    """One more aggregation under torch.profiler (a fresh engine, so the
    window includes refilling the concurrency slots)."""
    wall, rows, dev_us, _ = device_profile(torch, lambda: srv.run(policy, rounds=1))
    busy_s = sum(dev_us(e) for e in rows) / 1e6
    fleet_s = sum(dev_us(e) for e in rows if "segment_index" in e.key) / 1e6
    sel_s = sum(dev_us(e) for e in rows
                if "select_topk_fused" in e.key or "merge_pairs" in e.key) / 1e6
    top = sorted(rows, key=dev_us, reverse=True)[:8]
    emit(phase="profile", path="async", policy=policy.name, wall_s=wall,
         device_kernels=sum(e.count for e in rows), device_busy_s=busy_s,
         device_idle_share=(1.0 - busy_s / wall) if busy_s else "not measured",
         fleet_state_device_s=fleet_s, select_topk_device_s=sel_s,
         fleet_state_launches=sum(e.count for e in rows if "segment_index" in e.key),
         top_device_ms=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])


def phase_async_oracle(torch, data):
    """The batched event loop against its one-event-at-a-time oracle on the
    card, through trace-synthetic-week's first availability changes: the
    same jobs, cohorts, clock and bit-identical parameters."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy
    from repro_torch.fl.async_engine import AsyncRoundEngine

    out = {}
    for events in ("sequential", "batched"):
        cfg = FLConfig(n_devices=1000, k_select=10, rounds=3, l_ep=2, seed=1,
                       scenario="trace-synthetic-week", mode="async",
                       async_concurrency=30, staleness="polynomial",
                       async_events=events)
        srv = FLServer(cfg, MLPTask(), data, device="cuda")
        n_start = start_before_first_change(srv)
        eng = AsyncRoundEngine(srv, build_policy("fedrank", k=10, seed=0))
        log = record_jobs(eng)
        hist = eng.run(3)
        require_transitions(hist, n_start, cfg.n_devices, f"oracle/{events}")
        out[events] = (log, [(r.selected.tolist(), r.cum_time, r.cum_energy,
                              r.mean_staleness, r.n_available, r.acc) for r in hist],
                       eng.now, srv.global_params)
    (la, ha, na, pa), (lb, hb, nb, pb) = out["sequential"], out["batched"]
    require(la == lb and ha == hb and na == nb, "batched != sequential oracle")
    require(all(bool(torch.equal(pa[k], pb[k])) for k in pa), "params differ")
    emit(phase="async_oracle", jobs=len(la), aggregations=len(ha), t_virtual_s=na,
         n_available=[h[4] for h in hb], equal=True)


# ---------------------------------------------------------------------------
# the vmapped executor (paths 1, 4, 5) and the hierarchy (path 8)
# ---------------------------------------------------------------------------

EXEC_TOL = 1e-5              # vmapped vs sequential executor: fp32 sums in another order
CPU_CARD_TOL = 1e-4          # CPU vs card after a round: fp32 sums in another order


def params_diff(a, b) -> float:
    """Largest absolute difference between two parameter dicts."""
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def profile_summary(torch, fn) -> dict:
    """Wall s, device kernels, busy s and idle share of one profiled call."""
    wall, rows, dev_us, _ = device_profile(torch, fn)
    busy_s = sum(dev_us(e) for e in rows) / 1e6
    return dict(wall_s=wall, device_kernels=sum(e.count for e in rows),
                device_busy_s=busy_s,
                device_idle_share=(1.0 - busy_s / wall) if busy_s else "not measured")


def checked_policy(policy, srv, budgets=None):
    """Wrap ``policy.select`` so every cut it makes is checked: unique, online
    (inside ``ctx.available``), at most ``ctx.k``, and inside the context's
    region and that region's budget when the round is hierarchical.
    Returns the list of (region id, cohort) it saw."""
    import numpy as np

    seen = []
    select = policy.select

    def checked(ctx, probe_ids, probe_states):
        sel = np.asarray(select(ctx, probe_ids, probe_states), dtype=np.int64)
        ids = sel.tolist()
        require(len(ids) == len(set(ids)) <= ctx.k, (policy.name, ids, ctx.k))
        require(bool(ctx.available[sel].all()), (policy.name, "offline device selected"))
        if ctx.region_id is not None:
            require(bool((srv.pool.region[sel] == ctx.region_id).all()),
                    (policy.name, "selection outside its region"))
            if budgets is not None:
                require(len(ids) <= budgets[ctx.region_id], (ids, budgets))
        seen.append((ctx.region_id, ids))
        return sel

    policy.select = checked
    return seen


def phase_vmapped(torch, data):
    """Paths 1, 4 and 5 under ``executor="vmapped"`` beside ``"sequential"``,
    in turns, on the card: the same fedavg cohorts (and jobs) and params within
    EXEC_TOL per round or aggregation (sync rounds start from one global
    model: the sequential server's is copied into the vmapped one before each
    round); host s per round or aggregation, then one profiled round or
    aggregation of each (device kernels, idle share).  FedRank on path 1 is
    timed beside it, its cohorts reported."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy
    from repro_torch.fl.async_engine import AsyncRoundEngine

    out = {}
    for label, scenario, mode, policy_name in (
            ("path1", "high-churn", "sync", "fedavg"),
            ("path1", "high-churn", "sync", "fedrank"),
            ("path4", "trace-synthetic-week", "sync", "fedavg"),
            ("path5", "trace-synthetic-week", "async", "fedavg")):
        runs = {}
        for ex in ("sequential", "vmapped"):
            kw = (dict(mode="async", async_concurrency=30, staleness="polynomial")
                  if mode == "async" else {})
            cfg = FLConfig(n_devices=1000, k_select=10, rounds=3, l_ep=5,
                           scenario=scenario, executor=ex, **kw)
            srv = FLServer(cfg, MLPTask(), data, device="cuda")
            if scenario.startswith("trace"):
                start_before_first_change(srv)
            pol = build_policy(policy_name, k=10) if policy_name == "fedrank" \
                else build_policy(policy_name)
            runs[ex] = dict(srv=srv, pol=pol, host_s=[], cohorts=[],
                            eng=AsyncRoundEngine(srv, pol) if mode == "async" else None)
        seq, vm = runs["sequential"], runs["vmapped"]
        errs, same = [], []
        for r in range(3):
            order = ("sequential", "vmapped") if r % 2 == 0 else ("vmapped", "sequential")
            if mode == "sync":
                vm["srv"].global_params = {k: v.clone() for k, v in
                                           seq["srv"].global_params.items()}
            for ex in order:
                run = runs[ex]
                if mode == "sync":
                    res = run["srv"].run_round(run["pol"])
                    check_round(run["srv"], res, 10)
                else:
                    res = run["eng"].run(1)[-1]
                    check_async_history(torch, run["srv"], [res], 10)
                run["host_s"].append(res.host_time_s)
                run["cohorts"].append(res.selected.tolist())
                require(res.executor == ex, (res.executor, ex))
            same.append(seq["cohorts"][-1] == vm["cohorts"][-1])
            errs.append(params_diff(seq["srv"].global_params, vm["srv"].global_params))
            if policy_name == "fedavg":
                require(same[-1], (label, r, seq["cohorts"][-1], vm["cohorts"][-1]))
                require(errs[-1] <= EXEC_TOL, (label, r, errs[-1]))
        profiles = {}
        for ex in ("sequential", "vmapped"):
            run = runs[ex]
            fn = ((lambda run=run: run["srv"].run_round(run["pol"])) if mode == "sync"
                  else (lambda run=run: run["eng"].run(1)))
            profiles[ex] = profile_summary(torch, fn)
        key = f"{label}/{mode}/{policy_name}"
        out[key] = {ex: dict(host_s=runs[ex]["host_s"], **profiles[ex])
                    for ex in ("sequential", "vmapped")}
        out[key]["same_cohorts"] = same
        out[key]["max_param_diff"] = errs
        emit(phase="vmapped", run=key, tolerance=EXEC_TOL, **out[key])
    return out


PATH8_BUDGETS = (4, 3, 3)    # k=10 split over metro / suburban / rural


def path8_config(**kw):
    from repro_torch.fl import FLConfig

    base = dict(n_devices=1000, k_select=10, rounds=3, l_ep=5,
                scenario="hierarchical", executor="vmapped",
                region_budgets=list(PATH8_BUDGETS))
    base.update(kw)
    return FLConfig(**base)


def result_key(res):
    """What must be identical between two executions of one round."""
    return (res.round, res.selected.tolist(), res.probe_set.tolist(),
            res.failed.tolist(), res.stragglers.tolist(), res.adversaries.tolist(),
            res.r_t, res.r_e, res.cum_time, res.cum_energy, res.n_available,
            res.mean_staleness, res.max_staleness, sorted(res.tier_staleness.items()))


def phase_hierarchy_path(torch, data):
    """Path 8: the hierarchy at the main path's width on the card.  On
    ``hierarchical`` (three regions, budgets 4/3/3), fedavg and fedrank, 3
    sync rounds and 3 ``HierarchicalAsyncEngine`` aggregations each, with
    ``region_exec="stacked"`` and ``"sequential"`` in turns: identical
    cohorts, failures, clock and tier lags, params within EXEC_TOL; every
    cut online, unique, in its region and within its budget; select_topk
    launches per round.  Then 3 rounds on ``regional-outage`` and
    ``byzantine-signflip`` under each aggregator, sync and async (the
    adversaries a subset of the static mask)."""
    from repro_torch.fl import build_policy
    from repro_torch.fl.topology import HierarchicalAsyncEngine
    from repro_torch.kernels.select_topk.kernel import select_topk_cuda

    out = {}
    reset_counts()                                # every count to 0
    for policy_name in ("fedavg", "fedrank"):
        for mode in ("sync", "async"):
            runs = {}
            for region_exec in ("stacked", "sequential"):
                kw = (dict(mode="async", async_concurrency=30,
                           staleness="polynomial") if mode == "async" else {})
                srv = cuda_server(path8_config(region_exec=region_exec, **kw), data)
                pol = (build_policy("fedrank", k=10) if policy_name == "fedrank"
                       else build_policy("fedavg"))
                runs[region_exec] = dict(
                    srv=srv, pol=pol, host_s=[], launches=[], results=[],
                    cuts=checked_policy(pol, srv, PATH8_BUDGETS),
                    eng=HierarchicalAsyncEngine(srv, pol) if mode == "async" else None)
            for r in range(3):
                order = (("stacked", "sequential") if r % 2 == 0
                         else ("sequential", "stacked"))
                for region_exec in order:
                    run = runs[region_exec]
                    before = select_topk_cuda.launches
                    res = (run["srv"].run_round(run["pol"]) if mode == "sync"
                           else run["eng"].run(1)[-1])
                    run["launches"].append(select_topk_cuda.launches - before)
                    run["host_s"].append(res.host_time_s)
                    run["results"].append(res)
                    require(math.isfinite(res.acc), res.acc)
                    require(res.tier_staleness, "no tier lags recorded")
                a, b = runs["stacked"]["results"][-1], runs["sequential"]["results"][-1]
                require(result_key(a) == result_key(b),
                        ("stacked != sequential", result_key(a), result_key(b)))
            st, sq = runs["stacked"], runs["sequential"]
            err = params_diff(st["srv"].global_params, sq["srv"].global_params)
            require(err <= EXEC_TOL, ("stacked vs sequential params", err))
            bitwise = all(bool(torch.equal(t, sq["srv"].global_params[k]))
                          for k, t in st["srv"].global_params.items())
            for key_, t in st["srv"].global_params.items():
                require(t.is_cuda and bool(torch.isfinite(t).all()), key_)
            require(policy_name != "fedrank" or all(n > 0 for n in st["launches"]),
                    st["launches"])
            prof = profile_summary(
                torch, (lambda: st["srv"].run_round(st["pol"])) if mode == "sync"
                else (lambda: st["eng"].run(1)))
            key = f"hierarchical/{mode}/{policy_name}"
            out[key] = dict(
                cohorts=[r.selected.tolist() for r in st["results"]],
                regions_cut=sorted({rid for rid, _ in st["cuts"]}),
                tier_staleness=[r.tier_staleness for r in st["results"]],
                host_s_stacked=st["host_s"], host_s_sequential=sq["host_s"],
                select_topk_launches_per_round=st["launches"],
                params_bitwise_equal=bitwise, max_param_diff=err, profiled=prof)
            emit(phase="path8", run=key, **out[key])

    # regional outages: a dark region is skipped
    srv = cuda_server(path8_config(scenario="regional-outage", region_budgets=None,
                                    seed=2), data)
    pol = build_policy("fedrank", k=10)
    cuts = checked_policy(pol, srv)
    dark = []
    for _ in range(3):
        res = srv.run_round(pol)
        present = {k.split(":", 1)[1] for k in res.tier_staleness if k.startswith("region:")}
        sel_regions = {srv.pool.region_names[i] for i in srv.pool.region[res.selected]}
        require(sel_regions <= present, (sel_regions, present))
        dark.append(sorted(set(srv.pool.region_names) - present))
    out["regional-outage/sync/fedrank"] = dict(dark_regions=dark,
                                               cuts=len(cuts))
    emit(phase="path8", run="regional-outage/sync/fedrank", dark_regions=dark)

    # Byzantine clients under every aggregator, sync and async
    adversaries_seen = 0
    for mode in ("sync", "async"):
        for aggregator in ("mean", "trimmed_mean", "coordinate_median", "krum",
                           "multi_krum"):
            kw = (dict(mode="async", async_concurrency=30, staleness="polynomial")
                  if mode == "async" else {})
            srv = cuda_server(path8_config(scenario="byzantine-signflip",
                                            region_budgets=None,
                                            aggregator=aggregator, agg_trim=3,
                                            agg_f=3, **kw), data)
            pol = build_policy("fedavg")
            checked_policy(pol, srv)
            t0 = time.perf_counter()
            hist = srv.run(pol)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            mask = srv.attack.adversary_mask(srv.cfg.n_devices, srv.cfg.seed)
            for res in hist:
                require(bool(mask[res.adversaries].all()), "adversary outside the mask")
                require(set(res.adversaries.tolist()) <= set(res.selected.tolist()),
                        (res.adversaries, res.selected))
                adversaries_seen += len(res.adversaries)
            if mode == "async":
                check_async_history(torch, srv, hist, 10)
            key = f"byzantine-signflip/{mode}/{aggregator}"
            out[key] = dict(acc=[r.acc for r in hist], seconds=seconds,
                            adversaries=[r.adversaries.tolist() for r in hist],
                            host_s=[r.host_time_s for r in hist])
            emit(phase="path8", run=key, **out[key])
    require(adversaries_seen > 0, "no adversary in any Byzantine run")
    counts = read_counts()                        # read just after
    require(counts["select_topk"] > 0, counts)
    emit(phase="path8_launches", path="hierarchy", launches=counts)
    return counts, out


def cuda_server(cfg, data):
    from repro_torch.fl import FLServer, MLPTask

    return FLServer(cfg, MLPTask(), data, device="cuda")


def phase_cpu_agreement_hierarchy(torch):
    """One hierarchical FedRank round (``hierarchical``, 50 devices) and one
    krum round (``byzantine-signflip``) on the CPU and on the card from the
    same seeds: the same probe sets, cohorts and adversaries, params within
    1e-4."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy

    data = small_data(4000, 50)
    for label, kw, name in (
            ("hierarchical", dict(scenario="hierarchical"), "fedrank"),
            ("krum", dict(scenario="byzantine-signflip", aggregator="krum",
                          agg_f=1), "fedavg")):
        results, params = {}, {}
        for dev in ("cpu", "cuda"):
            srv = FLServer(FLConfig(n_devices=50, k_select=6, rounds=1, l_ep=2,
                                    seed=3, **kw), MLPTask(), data, device=dev)
            pol = build_policy(name, k=6, seed=0, device=dev) if name == "fedrank" \
                else build_policy(name)
            results[dev] = srv.run_round(pol)
            params[dev] = {k: v.cpu() for k, v in srv.global_params.items()}
        a, b = results["cpu"], results["cuda"]
        require(result_key(a) == result_key(b), (label, result_key(a), result_key(b)))
        err = params_diff(params["cpu"], params["cuda"])
        require(err <= CPU_CARD_TOL, (label, err))
        emit(phase="cpu_vs_card", path=label, cohort=b.selected.tolist(),
             adversaries=b.adversaries.tolist(), tier_staleness=b.tier_staleness,
             max_param_err=err, tolerance=CPU_CARD_TOL)


# ---------------------------------------------------------------------------
# flash_attention and LM serving (path 6)
# ---------------------------------------------------------------------------

H100_BF16_FLOPS = 989e12     # published dense bf16 tensor-core peak, SXM, 700 W
FA_TOL32 = 2e-5              # fp32 inputs: sums in another order (see docstring)
FA_ULP_BF16 = 2.0 ** -7      # bf16 inputs: one bf16 ulp of the output's magnitude
LM_TOL = 1e-4                # CPU vs card, smoke configs: fp32 sums in another order
FULL_WIDTH_TOL = 1e-4        # full width, 2 layers, fp32: x max(1, max |logit|)


def flash_bound_ms(b, s, h, kv, dh, causal, window, elt):
    """Least time: 4 Dh operations (q.k and p.v) per allowed pair and head
    (``kernels/work.py``'s formula, which the dry-run's counter books too)
    over the inputs' rate (bf16 tensor cores, or fp32 on the CUDA cores), or
    q + k + v read once and o written once over HBM bandwidth."""
    from repro_torch.kernels.work import flash_flops

    ops = flash_flops(b, s, h, dh, causal, window)
    nbytes = float(elt) * (2 * b * s * h * dh + 2 * b * s * kv * dh)
    rate = H100_FP32_FLOPS if elt == 4 else H100_BF16_FLOPS
    t_ops, t_bytes = ops / rate, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_inputs(torch, b, s, h, kv, dh, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, s, n, dh, generator=g, device="cuda").to(dtype)
            for n in (h, kv, kv)]


def flash_plain(torch, q, k, v, causal, window):
    """The plain version in fp32 on the same inputs, one KV head at a time so
    that its (G, S, S) scores fit."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = q.shape[2] // k.shape[2]
    return torch.cat([attention_ref(q[:, :, j * g:(j + 1) * g].float(),
                                    k[:, :, j:j + 1].float(), v[:, :, j:j + 1].float(),
                                    causal=causal, window=window)
                      for j in range(k.shape[2])], dim=2)


# The shapes paths 6 and 11 give the kernel: Yi-6B's prefill (batch 4 x
# 1024, 32 query heads over 4 KV heads, Dh=128) and h2o-danube's (1 x 5000
# past its 4096 window, 32 over 8, Dh=120), both causal; then path 11's.
FA_MAIN_CASES = {
    "yi_prefill": dict(b=4, s=1024, kv=4, g=8, dh=128, causal=True, window=None),
    "danube_prefill": dict(b=1, s=5000, kv=8, g=4, dh=120, causal=True, window=4096),
    # path 11's: whisper-medium's encoder (bidirectional over 1500 frames,
    # 16 heads over 16, Dh=64) and OLMoE's prefill (4 x 1024, 16 over 16, Dh=128)
    "whisper_encoder": dict(b=4, s=1500, kv=16, g=1, dh=64, causal=False, window=None),
    "olmoe_prefill": dict(b=4, s=1024, kv=16, g=1, dh=128, causal=True, window=None),
}


def phase_flash_vs_plain(torch):
    """The kernel against its plain version over sequence lengths (ragged
    ones too), GQA group sizes, head widths (gemma-7b's Dh=256 too), masks,
    both input types and path 6's own shapes; bf16 with Dh <= 128 takes the
    tensor-core kernel, so its row layout gets cases of its own: G of 16 and
    64, G=5 with windows inside one 64-key tile, Dh=120 at ragged S."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_route

    masks = [(True, None), (False, None), (True, 64), (False, 64), (True, 1024),
             (False, 1024)]
    cases = [dict(b=2 if s < 1000 else 1, s=s, kv=2, g=g, dh=dh, causal=c, window=w)
             for s in (1, 7, 128, 129, 1000) for g in (1, 4, 5, 8)
             for dh in (64, 120, 128) for c, w in masks]
    cases += [dict(b=1, s=s, kv=2, g=g, dh=dh, causal=c, window=w)
              for s, g, dh, c, w in (
                  (4096, 8, 128, True, None), (4096, 4, 120, True, 4096),
                  (4096, 5, 64, False, 1024), (4096, 1, 64, False, None),
                  (8192, 8, 128, True, None), (8192, 4, 120, True, 4096),
                  (8192, 5, 64, True, 1024), (8192, 1, 128, False, None),
                  (8192, 8, 120, False, 4096), (8192, 4, 64, True, 64))]
    # gemma-7b's layout: 16 query heads over 16 KV heads (G=1), Dh=256
    cases += [dict(b=b, s=s, kv=16, g=1, dh=256, causal=True, window=None)
              for b, s in ((2, 129), (1, 1000))]
    # the tensor-core kernel's rows: 4 and 1 positions a CTA (G = 16, 64)
    cases += [dict(b=2, s=s, kv=2, g=g, dh=dh, causal=c, window=w)
              for s in (7, 129) for g in (16, 64) for dh in (64, 120, 128)
              for c, w in masks[:3]]
    # G=5 (12 positions, 60 of 64 rows) with windows inside one key tile
    cases += [dict(b=1, s=s, kv=2, g=5, dh=64, causal=c, window=w)
              for s in (129, 1000) for w in (1, 17, 63) for c in (True, False)]
    # Dh=120 (padded to 128) at ragged S
    cases += [dict(b=1, s=s, kv=2, g=g, dh=120, causal=c, window=w)
              for s in (65, 200, 1001) for g in (4, 8)
              for c, w in ((True, None), (True, 100), (False, None))]
    cases += [dict(c, label=label) for label, c in FA_MAIN_CASES.items()]
    errs, counts, summary = {}, {}, []
    for i, c in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = flash_inputs(torch, c["b"], c["s"], c["kv"] * c["g"], c["kv"],
                                   c["dh"], dtype, seed=i)
            got = flash_attention_cuda(q, k, v, causal=c["causal"], window=c["window"])
            torch.cuda.synchronize()
            ref = flash_plain(torch, q, k, v, c["causal"], c["window"])
            err = (got.float() - ref).abs()
            if dtype == torch.float32:
                ok = bool((err <= FA_TOL32).all())
            else:
                ok = bool((err <= FA_ULP_BF16 * ref.abs() + FA_TOL32).all())
            key = f"{str(dtype).replace('torch.', '')}/{flash_route(dtype, c['dh'])}"
            require(got.shape == q.shape and got.dtype == dtype and ok,
                    f"flash_attention {c} {key}: max err {float(err.max())}")
            errs[key] = max(errs.get(key, 0.0), float(err.max()))
            counts[key] = counts.get(key, 0) + 1
            if c["s"] >= 1000 or c["dh"] > 128:
                summary.append([c.get("label"), c["b"], c["s"], c["kv"], c["g"], c["dh"],
                                c["causal"], c["window"], key, float(err.max())])
        del q, k, v, got, ref, err
    torch.cuda.empty_cache()
    emit(phase="kernel_vs_plain", kernel="flash_attention", cases=2 * len(cases),
         cases_by_route=counts,
         tolerance={"float32": f"{FA_TOL32} abs",
                    "bfloat16": f"{FA_ULP_BF16}*|ref| + {FA_TOL32}"},
         max_abs_err=errs,
         results_s_ge_1000_or_dh_gt_128=[["main_path", "b", "s", "kv", "g", "dh",
                                          "causal", "window", "dtype/route", "max_abs_err"]]
         + summary)
    return errs


def phase_flash_timings(torch, card):
    """Kernel, plain version, bound and SDPA at the serving shapes (whisper's
    encoder bidirectional, the rest causal).  SDPA is one PyTorch call for
    the same function: ``is_causal`` for a causal mask or none, a boolean
    (S, S) ``attn_mask`` (causal and window) for a sliding window;
    its largest difference from the kernel is printed beside its time."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_route

    rows = {}
    for label, b, s, h, kv, dh, window, dtype, plain, causal in (
            ("yi_prefill", 4, 1024, 32, 4, 128, None, torch.bfloat16, True, True),
            ("yi_prefill_fp32", 4, 1024, 32, 4, 128, None, torch.float32, True, True),
            ("yi_s8192", 1, 8192, 32, 4, 128, None, torch.bfloat16, True, True),
            ("yi_s32768", 1, 32768, 32, 4, 128, None, torch.bfloat16, False, True),
            ("danube_prefill", 1, 5000, 32, 8, 120, 4096, torch.bfloat16, True, True),
            ("danube_s8192", 1, 8192, 32, 8, 120, 4096, torch.bfloat16, True, True),
            ("hymba_prefill", 4, 2048, 25, 5, 64, 1024, torch.bfloat16, True, True),
            ("hymba_attn_s8192", 1, 8192, 25, 5, 64, 1024, torch.bfloat16, True, True),
            ("whisper_encoder", 4, 1500, 16, 16, 64, None, torch.bfloat16, True, False),
            ("olmoe_prefill", 4, 1024, 16, 16, 128, None, torch.bfloat16, True, True)):
        q, k, v = flash_inputs(torch, b, s, h, kv, dh, dtype, seed=s + h)
        ms = cuda_ms(torch, lambda: flash_attention_cuda(q, k, v, causal=causal,
                                                         window=window))
        plain_ms = (cuda_ms(torch, lambda: flash_plain(torch, q, k, v, causal, window))
                    if plain else None)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            def library():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=True)
        else:
            pos = torch.arange(s, device="cuda")
            allowed = ((pos[None, :] <= pos[:, None])
                       & (pos[None, :] > pos[:, None] - window))

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=allowed,
                                                      enable_gqa=True)
        lib_ms = cuda_ms(torch, library)
        lib_diff = float((library().transpose(1, 2).float()
                          - flash_attention_cuda(q, k, v, causal=causal, window=window)
                          .float()).abs().max())
        bound, bound_by = flash_bound_ms(b, s, h, kv, dh, causal, window, q.element_size())
        rows[label] = dict(b=b, s=s, h=h, kv=kv, dh=dh, window=window, causal=causal,
                           dtype=str(dtype).replace("torch.", ""),
                           route=flash_route(dtype, dh), ms=ms,
                           plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                           library_ms=lib_ms)
        emit(phase="timing", kernel="flash_attention", shape=label, card=card,
             **rows[label], library_max_abs_diff=lib_diff,
             note=None if plain else "plain version not timed: its (S, S) scores "
                                     "do not fit")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return rows


def call_us(torch, fn, calls):
    """Host microseconds of each of ``calls`` calls of ``fn``, from the call
    to its return, the card idle before each (what a call costs the host,
    not the kernel's time)."""
    out = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out.append(1e6 * (time.perf_counter() - t0))
    return out


def phase_op_route(torch, card, kernel, op_name, op, direct, counter, shape, args,
                   kwargs=None, calls=400, turns=4):
    """The dispatcher op (``op``, the public function the model calls)
    against a direct call of its CUDA wrapper (``direct``) on the same
    inputs: the same bits; exactly one launch a call each on ``counter``;
    the host microseconds a call of each (medians, in turns)."""
    kwargs = kwargs or {}

    def outs(x):
        return x if isinstance(x, tuple) else (x,)

    before = counter.launches
    got = outs(op(*args, **kwargs))
    require(counter.launches == before + 1, f"{op_name}: {counter.launches - before} "
                                            "launches for one op call")
    before = counter.launches
    want = outs(direct(*args, **kwargs))
    require(counter.launches == before + 1, f"{kernel}: {counter.launches - before} "
                                            "launches for one direct call")
    torch.cuda.synchronize()
    require(len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want)),
            f"{op_name} differs from the direct {kernel} launch")
    times = {"op": [], "direct": []}
    for _ in range(turns):
        times["op"] += call_us(torch, lambda: op(*args, **kwargs), calls // turns)
        times["direct"] += call_us(torch, lambda: direct(*args, **kwargs), calls // turns)
    row = dict(kernel=kernel, op=op_name, shape=shape, calls=calls, bit_equal=True,
               launches_per_call=1, op_host_us=statistics.median(times["op"]),
               direct_host_us=statistics.median(times["direct"]))
    row["op_minus_direct_us"] = row["op_host_us"] - row["direct_host_us"]
    emit(phase="op_route", card=card, **row)
    return row


def phase_flash_op_route(torch, card):
    """``repro_torch::flash_attention`` against ``flash_attention_cuda`` at
    Yi-6B's prefill shape (B=4, S=1024, 32 heads over 4, Dh=128, bf16)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_attention

    c = FA_MAIN_CASES["yi_prefill"]
    q, k, v = flash_inputs(torch, c["b"], c["s"], c["kv"] * c["g"], c["kv"], c["dh"],
                           torch.bfloat16, seed=7)
    return {"yi_prefill": phase_op_route(
        torch, card, "flash_attention", "repro_torch::flash_attention", flash_attention,
        flash_attention_cuda, flash_attention_cuda, "yi_prefill", (q, k, v),
        dict(causal=True, window=None))}


def phase_ssm_op_route(torch, card):
    """``repro_torch::selective_scan`` and ``repro_torch::wkv6`` against
    ``selective_scan_cuda`` and ``wkv6_cuda`` at a decode step (B=4, T=1)
    of Hymba-1.5B (inner 1600, state 16, B and C strided) and of RWKV6-3B
    (40 heads of 64): decode is host-bound, 32 such calls a step."""
    from repro_torch.kernels.mamba.kernel import selective_scan_cuda
    from repro_torch.kernels.mamba.ops import selective_scan
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
    from repro_torch.kernels.rwkv6.ops import wkv6_heads

    return {
        "hymba_decode": phase_op_route(
            torch, card, "mamba", "repro_torch::selective_scan", selective_scan,
            selective_scan_cuda, selective_scan_cuda, "hymba_decode",
            scan_inputs(torch, 4, 1, 1600, 16, seed=5, model=True)),
        "rwkv6_decode": phase_op_route(
            torch, card, "rwkv6", "repro_torch::wkv6", wkv6_heads, wkv6_cuda, wkv6_cuda,
            "rwkv6_decode", wkv_inputs(torch, 4, 1, 40, 64, seed=5, decay="model")),
    }


# ---------------------------------------------------------------------------
# sgd_update: the vmapped executor's update of a stacked leaf
# ---------------------------------------------------------------------------

SGD_LR = 0.1                 # the benchmark cells' client lr
# (label, clients, a client's leaf shape, dtype name): the main path's leaves
SGD_MAIN = (("yi_embed", 10, (64000, 4096), "bfloat16"),
            ("olmoe_expert", 10, (1, 64, 2048, 1024), "bfloat16"),
            ("mlp_fp32", 10, (32, 128), "float32"))


def sgd_bytes(k, n, elt, broadcast):
    """a read once, g read once, out written once."""
    return elt * (n if broadcast else k * n) + 2 * elt * k * n


def sgd_leaf_inputs(torch, k, shape, dtype, broadcast, seed, *, offset=0, pad=0):
    """g (k, *shape) and a: one client's leaf expanded over k (broadcast) or
    k leaves; ``offset`` elements into the storage (an unaligned start) and
    ``pad`` elements between clients (a client stride of its own)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = math.prod(shape)

    def draw(rows, scale):
        flat = torch.randn(offset + rows * (n + pad), generator=gen, device="cuda") * scale
        return flat.to(dtype)[offset:].view(rows, n + pad)[:, :n].view((rows,) + shape)
    g = draw(k, 1e-2)
    a = draw(1, 2e-2)[0].expand((k,) + shape) if broadcast else draw(k, 2e-2)
    return a, g


def sgd_equal(torch, got, a, g, lr):
    """The kernel's leaf against ``fl/client.py::_sgd_leaf`` client by
    client, bit for bit: the number of entries that differ."""
    from repro_torch.fl.client import _sgd_leaf

    step = _sgd_leaf(lr)
    bits = torch.int16 if got.element_size() == 2 else torch.int32
    return sum(int((got[j].view(bits) != step(a[j], g[j]).view(bits)).sum())
               for j in range(got.shape[0]))


def phase_sgd_update_vs_plain(torch):
    """``sgd_update_cuda`` against ``_sgd_leaf`` on the card, bit for bit: the
    main path's leaves (Yi-6B's embedding, an OLMoE expert leaf, an fp32 MLP
    leaf), broadcast and stacked, then the edges: a ragged end, an
    unaligned start, client strides of their own, fp16, one client, client
    counts off the unroll."""
    from repro_torch.kernels.sgd_update.kernel import sgd_update_cuda

    cases = [(label, k, shape, dt, broadcast, 0, 0)
             for label, k, shape, dt in SGD_MAIN for broadcast in (True, False)]
    cases += [("ragged", 3, (4099,), "bfloat16", b, 0, 0) for b in (True, False)]
    cases += [("unaligned", 5, (1000,), "bfloat16", b, 1, 0) for b in (True, False)]
    cases += [("client_stride", 6, (37, 64), "bfloat16", b, 0, 8) for b in (True, False)]
    cases += [("fp16", 7, (129, 8), "float16", b, 0, 0) for b in (True, False)]
    cases += [("one_client", 1, (4096, 11), "bfloat16", False, 0, 0),
              ("k5_broadcast", 5, (3, 1000), "bfloat16", True, 0, 0),
              ("k5_strided_fp32", 5, (77,), "float32", False, 3, 5)]
    worst = 0
    for i, (label, k, shape, dt, broadcast, offset, pad) in enumerate(cases):
        a, g = sgd_leaf_inputs(torch, k, shape, getattr(torch, dt), broadcast, seed=i,
                               offset=offset, pad=pad)
        got = sgd_update_cuda(a, g, SGD_LR)
        torch.cuda.synchronize()
        diff = sgd_equal(torch, got, a, g, SGD_LR)
        emit(phase="vs_plain", kernel="sgd_update", case=label, k=k, shape=list(shape),
             dtype=dt, broadcast=broadcast, offset=offset, pad=pad,
             a_stride0=a.stride(0), g_stride0=g.stride(0), entries_differing=diff)
        require(got.is_contiguous() and diff == 0, (label, broadcast, diff))
        worst = max(worst, diff)
        del a, g, got
        torch.cuda.empty_cache()
    return worst


def phase_sgd_update_timings(torch, card):
    """The kernel, the plain version (the executor's update before it: five
    fp32 passes, client by client past 2^26 elements), the bound (bytes over
    3.35 TB/s) and ``torch.add(a, g, alpha=-lr)``, one PyTorch call, as the
    yardstick (timed only; the port never calls it) at the main path's
    leaves, broadcast and stacked."""
    from repro_torch.kernels.sgd_update.kernel import launch_config, sgd_update_cuda
    from repro_torch.kernels.sgd_update.ref import sgd_update_ref

    rows = {}
    for label, k, shape, dt in SGD_MAIN:
        dtype = getattr(torch, dt)
        for broadcast in (True, False):
            a, g = sgd_leaf_inputs(torch, k, shape, dtype, broadcast, seed=1)
            n = math.prod(shape)
            nbytes = sgd_bytes(k, n, a.element_size(), broadcast)
            ms = cuda_ms(torch, lambda: sgd_update_cuda(a, g, SGD_LR))
            plain_ms = cuda_ms(torch, lambda: sgd_update_ref(a, g, SGD_LR), reps=5, warmup=1)
            library_ms = cuda_ms(torch, lambda: torch.add(a, g, alpha=-SGD_LR), reps=5,
                                 warmup=1)
            key = f"{label}_{'broadcast' if broadcast else 'stacked'}"
            rows[key] = dict(k=k, shape=list(shape), dtype=dt, broadcast=broadcast,
                             bytes=nbytes, ms=ms, plain_ms=plain_ms,
                             bound_ms=1e3 * nbytes / H100_BYTES_PER_S, bound_by="bytes",
                             library_ms=library_ms,
                             tb_per_s=nbytes / ms / 1e9,
                             share_of_peak=nbytes / ms / 1e9 / (H100_BYTES_PER_S / 1e12),
                             launch=launch_config(dtype, broadcast))
            emit(phase="timing", kernel="sgd_update", case=key, card=card, **rows[key])
            del a, g
            torch.cuda.empty_cache()
    yi = rows["yi_embed_stacked"]
    require(yi["share_of_peak"] >= 0.8,
            ("sgd_update under 80% of 3.35 TB/s at Yi's embedding", yi["share_of_peak"]))
    return rows


def tree_to(tree, device):
    return {k: (tree_to(v, device) if isinstance(v, dict) else v.to(device))
            for k, v in tree.items()}


def phase_cpu_agreement_lm(torch):
    """Smoke configs (fp32, 2 layers): the same weights prefill a prompt (by
    the kernel route) and decode 8 teacher-forced tokens on the CPU and on
    the card; the logits agree within LM_TOL."""
    import numpy as np

    from repro_torch.configs import get_model_config
    from repro_torch.data import make_lm_stream
    from repro_torch.models import transformer as T

    # h2o-danube and hymba past their window of 64; rwkv6 in whole 64-token chunks
    for arch, prompt in (("yi-6b", 40), ("h2o-danube-3-4b", 80), ("hymba-1.5b", 80),
                         ("rwkv6-3b", 128)):
        cfg = get_model_config(arch, smoke=True)
        params = T.init_params(0, cfg, "cpu")
        tok = make_lm_stream(2 * (prompt + 8), vocab=cfg.vocab_size, seed=1)
        tok = np.asarray(tok, np.int64).reshape(2, prompt + 8)
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_to(params, dev)
            t = torch.as_tensor(tok, device=dev)
            logits, st = T.prefill(p, cfg, t[:, :prompt], max_len=prompt + 8, impl="flash")
            steps = [logits.cpu()]
            for i in range(prompt, prompt + 8):
                lg, st = T.decode_step(p, cfg, st, t[:, i])
                steps.append(lg.cpu())
            out[dev] = steps
        err = max(float((a - b).abs().max()) for a, b in zip(out["cpu"], out["cuda"]))
        require(err <= LM_TOL, f"{arch}: CPU and card logits differ by {err}")
        emit(phase="cpu_vs_card", model=arch + "-smoke", prompt=prompt, decode_steps=8,
             max_abs_logit_err=err, tolerance=LM_TOL)


def phase_full_width_agreement(torch):
    """Full width, depth cut to 2 layers, fp32 weights: prefill by the kernel
    route, then decoding through the ring cache and the recurrent states,
    reproduce forward(impl="naive") over the whole sequence.  h2o-danube's
    prompt is past its 4096 window and Hymba's past its 1024, so the prefill
    packs a wrapped ring and decode reads it; RWKV6's forward over 1024
    tokens takes the chunked form, its prefill the rwkv6 kernel."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_model_config
    from repro_torch.data import make_lm_stream
    from repro_torch.models import transformer as T

    for arch, b, prompt in (("yi-6b", 2, 1000), ("h2o-danube-3-4b", 1, 4200),
                            ("hymba-1.5b", 2, 1100), ("rwkv6-3b", 2, 1016)):
        cfg = dataclasses.replace(get_model_config(arch), n_layers=2, dtype="float32")
        params = T.init_params(0, cfg, "cuda")
        n = prompt + 8
        tok = np.asarray(make_lm_stream(b * n, vocab=cfg.vocab_size, seed=2),
                         np.int64).reshape(b, n)
        tok = torch.as_tensor(tok, device="cuda")
        full, _ = T.forward(params, cfg, tok, impl="naive")
        scale = max(1.0, float(full.abs().max()))
        pre, st = T.prefill(params, cfg, tok[:, :prompt], max_len=n, impl="flash")
        err_pre = float((pre - full[:, :prompt]).abs().max())
        err_dec = 0.0
        for i in range(prompt, n):
            lg, st = T.decode_step(params, cfg, st, tok[:, i])
            err_dec = max(err_dec, float((lg - full[:, i]).abs().max()))
        torch.cuda.synchronize()
        require(bool(torch.isfinite(full).all()) and full.shape == (b, n, cfg.vocab_size))
        require(max(err_pre, err_dec) <= FULL_WIDTH_TOL * scale,
                f"{arch}: prefill/decode vs forward {err_pre}, {err_dec} (scale {scale})")
        emit(phase="full_width_agreement", model=arch, layers=2, dtype="float32",
             batch=b, prompt=prompt, decode_steps=8, max_abs_logit=scale,
             prefill_err=err_pre, decode_err=err_dec,
             tolerance=f"{FULL_WIDTH_TOL}*max(1,|logit|)")
        del params, full, pre, st
        torch.cuda.empty_cache()


def phase_serving_path(torch):
    """Path 6, LM serving at full width and depth (bf16): Yi-6B prefill +
    decode, h2o-danube past its window, and continuous batching on Yi-6B."""
    import numpy as np

    from repro_torch.configs import get_model_config
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.scheduler import ContinuousBatcher, Request
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T

    reset_counts()                                # every count to 0
    runs = {}
    for label, arch, batch, prompt, gen in (("yi-6b", "yi-6b", 4, 1024, 32),
                                            ("h2o-danube-3-4b", "h2o-danube-3-4b", 1, 5000, 16)):
        cfg = get_model_config(arch)
        before = flash_attention_cuda.launches
        before_mma = flash_attention_cuda.mma_launches
        torch.cuda.reset_peak_memory_stats()
        stats = serve(arch, smoke=False, batch=batch, prompt_len=prompt, gen=gen,
                      verbose=False, device="cuda")
        launched = flash_attention_cuda.launches - before
        mma = flash_attention_cuda.mma_launches - before_mma
        require(all(math.isfinite(v) and v > 0 for v in stats.values()), stats)
        require(launched == cfg.n_layers, f"{arch}: {launched} flash launches")
        require(mma == launched, f"{arch}: {mma} of {launched} bf16 prefill launches "
                                 "on the tensor-core kernel")
        runs[label] = launched
        if label == "yi-6b":
            _PATH6["yi_prefill_s"] = stats["prefill_s"]
        emit(phase="serve", path="lm_serving", model=arch, layers=cfg.n_layers,
             params=cfg.param_count(), batch=batch, prompt=prompt, gen=gen, **stats,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             flash_attention_launches=launched, flash_attention_mma_launches=mma,
             ring_wraps=bool(cfg.window and prompt > cfg.window))
        torch.cuda.empty_cache()

    cfg = get_model_config("yi-6b")
    params = T.init_params(0, cfg, "cuda")
    rng = np.random.default_rng(0)
    batcher = ContinuousBatcher(cfg, params, batch_slots=4, max_len=256, device="cuda")
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 129, size=8)]
    for i, p in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=p, max_new=16))
    before = flash_attention_cuda.launches
    st = batcher.run()
    launched = flash_attention_cuda.launches - before
    require(st.completed == 8 and st.tokens_out == 8 * 16, st)
    require(all(len(r.out) == 16 and all(0 <= t < cfg.vocab_size for t in r.out)
                for r in batcher.completed))
    require(launched == 0, f"continuous batching launched {launched} attention kernels")
    runs["continuous_batching"] = launched
    counts = read_counts()                        # read just after
    emit(phase="serve", path="lm_serving", model="yi-6b", mode="continuous_batching",
         slots=4, requests=8, prompt_lens=[len(p) for p in prompts], max_new=16,
         completed=st.completed, decode_steps=st.decode_steps, tokens_out=st.tokens_out,
         elapsed_s=st.elapsed_s, tok_per_s=st.tok_per_s, mean_ttft_s=st.mean_ttft_s,
         mean_latency_s=st.mean_latency_s, flash_attention_launches=launched,
         note="prompts are fed token by token through decode_step, as in the "
              "reference: no attention kernel is expected on this path")
    emit(phase="main_launches", path="lm_serving", launches=counts, per_run=runs)
    del params, batcher
    torch.cuda.empty_cache()
    return counts, runs


def phase_serve_profile(torch):
    """One Yi-6B serve call (batch 4, prompt 1024, 4 new tokens; weights
    drawn inside the call) under torch.profiler."""
    from repro_torch.launch.serve import serve

    wall, rows, dev_us, _ = device_profile(
        torch, lambda: serve("yi-6b", smoke=False, batch=4, prompt_len=1024, gen=4,
                             verbose=False, device="cuda"))
    busy_s = sum(dev_us(e) for e in rows) / 1e6
    flash = kernel_times(rows, dev_us, "flash_fwd")
    top = sorted(rows, key=dev_us, reverse=True)[:8]
    emit(phase="profile", path="lm_serving", model="yi-6b", wall_s=wall,
         device_kernels=sum(e.count for e in rows), device_busy_s=busy_s,
         device_idle_share=(1.0 - busy_s / wall) if busy_s else "not measured",
         flash_attention_device_s=sum(ms for ms, _ in flash.values()) / 1e3,
         flash_attention_launches=sum(n for _, n in flash.values()), flash_kernels=flash,
         top_device_ms=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# mamba and rwkv6, and SSM serving (path 7)
# ---------------------------------------------------------------------------

SSM_TOL = 2e-5               # fp32: x max(1, max |ref|) of the output's row
SSM_NO_LIBRARY = ("none: no single PyTorch call computes a selective scan or a "
                  "WKV recurrence")


def check_rows(torch, got, ref, reduce_dims, what):
    """Every element within SSM_TOL * max(1, max |ref|) of its row (the
    dims in ``reduce_dims`` span a row); returns the max abs error."""
    require(got.shape == ref.shape and got.dtype == torch.float32,
            f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(ref.shape)}")
    scale = ref.abs().amax(dim=reduce_dims, keepdim=True).clamp(min=1.0)
    err = (got - ref).abs()
    require(bool(torch.isfinite(got).all()) and bool((err <= SSM_TOL * scale).all()),
            f"{what}: max err {float(err.max())}, finite {bool(torch.isfinite(got).all())}")
    return float(err.max())


def scan_inputs(torch, b, t, inner, state, seed, *, random_h0=True, model=False):
    """Selective-scan inputs.  ``model``: as Hymba's ``mamba_scan`` makes
    them: dt = softplus(N(0, 1) - 4.6), B and C column slices of one fp32
    projection (rows of dt_rank + 2 state floats: strided views), A =
    -exp(log(1..state)).  Otherwise the reference test's distributions."""
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    x = normal(b, t, inner)
    if model:
        dt_rank = max(1, inner // 16)
        _, bm, cm = torch.split(normal(b, t, dt_rank + 2 * state),
                                [dt_rank, state, state], dim=-1)
        dt = F.softplus(normal(b, t, inner) - 4.6)
        a = -torch.arange(1, state + 1, dtype=torch.float32,
                          device="cuda").expand(inner, state).contiguous()
    else:
        dt = (normal(b, t, inner) * 0.02 + 0.05).abs()
        bm, cm = normal(b, t, state), normal(b, t, state)
        a = -(normal(inner, state) * 0.5 + 1.0).abs()
    h0 = normal(b, inner, state) * 0.1 if random_h0 else torch.zeros(
        b, inner, state, device="cuda")
    return x, dt, bm, cm, a, h0


def ssm_bound_ms(nbytes, ops, exps):
    """The largest of the bytes over HBM bandwidth, the fp32 operations over
    the fp32 rate and the exps over the special-function units' rate; the
    last two are both "operations"."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = max(ops / H100_FP32_FLOPS, exps / H100_SFU_EXPS)
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def scan_bound_ms(b, t, inner, state):
    """Least time: x, dt, B, C, A, h0 read once, y and h_T written once,
    over HBM bandwidth; or 7 fp32 operations per (b, t, c, s) (the exp
    counted as one) plus one per (b, t, c) over the fp32 rate; or one exp
    per (b, t, c, s) over the special-function units' 16 a clock and SM
    (H100_SFU_EXPS), the larger at Hymba's shapes (``kernels/work.py``'s
    formulas, which the dry-run's counter books too)."""
    from repro_torch.kernels.work import scan_exps, scan_ops

    nbytes = 4.0 * (3 * b * t * inner + 2 * b * t * state + inner * state
                    + 2 * b * inner * state)
    return ssm_bound_ms(nbytes, scan_ops(b, t, inner, state), scan_exps(b, t, inner, state))


# Path 7's shape: Hymba's prefill, batch 4 x 2048 tokens, inner 1600, state 16
SCAN_MAIN = dict(b=4, t=2048, inner=1600, state=16, random_h0=False, model=True)


def phase_scan_vs_plain(torch):
    """The mamba kernel against its plain version over T, inner, state,
    batch and h0, every lane split of the state, path 7's own shapes (B and C
    strided views: Hymba's prefill, a decode step, B=1 at T=8192) and a
    split-T composition."""
    from repro_torch.kernels.mamba.kernel import selective_scan_cuda
    from repro_torch.kernels.mamba.ref import selective_scan_ref

    cases = [dict(b=b, t=t, inner=inner, state=state, random_h0=h0)
             for t in (1, 2, 7, 64, 65, 1000) for inner in (64, 100, 1600)
             for state in (8, 16) for b in (1, 4) for h0 in (False, True)]
    cases += [dict(b=2, t=129, inner=96, state=st, random_h0=True)
              for st in (1, 4, 20, 32, 64)]
    cases += [dict(SCAN_MAIN, label="hymba_prefill"),
              dict(SCAN_MAIN, t=1, random_h0=True, label="hymba_decode"),
              dict(SCAN_MAIN, b=1, t=8192, label="hymba_t8192")]
    err_y = err_h = 0.0
    for i, c in enumerate(cases):
        args = scan_inputs(torch, c["b"], c["t"], c["inner"], c["state"], seed=i,
                           random_h0=c["random_h0"], model=c.get("model", False))
        y, h = selective_scan_cuda(*args)
        torch.cuda.synchronize()
        ry, rh = selective_scan_ref(*args)
        err_y = max(err_y, check_rows(torch, y, ry, (1,), f"mamba y {c}"))
        err_h = max(err_h, check_rows(torch, h, rh, (2,), f"mamba h_T {c}"))
    # split-T composition at path 7's shape: two calls with the state carried
    x, dt, bm, cm, a, h0 = scan_inputs(torch, **{k: SCAN_MAIN[k] for k in (
        "b", "t", "inner", "state")}, seed=999, random_h0=True, model=True)
    y, h = selective_scan_cuda(x, dt, bm, cm, a, h0)
    cut = 1000
    y1, h1 = selective_scan_cuda(x[:, :cut], dt[:, :cut], bm[:, :cut], cm[:, :cut], a, h0)
    y2, h2 = selective_scan_cuda(x[:, cut:], dt[:, cut:], bm[:, cut:], cm[:, cut:], a, h1)
    torch.cuda.synchronize()
    err_split = max(check_rows(torch, torch.cat([y1, y2], 1), y, (1,), "mamba split y"),
                    check_rows(torch, h2, h, (2,), "mamba split h_T"))
    emit(phase="kernel_vs_plain", kernel="mamba", cases=len(cases) + 1,
         tolerance=f"{SSM_TOL}*max(1,|ref|) of the (batch, channel) row",
         max_abs_err_y=err_y, max_abs_err_h=err_h, max_abs_err_split_t=err_split,
         main_shape={k: SCAN_MAIN[k] for k in ("b", "t", "inner", "state")},
         b_c_strided=True)
    return max(err_y, err_h, err_split)


def wkv_inputs(torch, b, t, h, n, seed, *, decay="mild", random_s0=True, u_per_batch=False):
    """RWKV6 inputs in the model's layout: r, k, v, logw (B, T, H, n) views
    of (B, T, H * n) tensors, u (H, n) (or (B, H, n) if ``u_per_batch``),
    s0 (B, H, n, n).  ``decay``: "mild"
    logw = -exp(N(-2, 1)) (the reference test's), "strong" -exp(N(1, 1))
    (where the chunked form overflows), "model" -exp(N(-6, 0.5)) (the
    init's w0 = -6)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    mean, sd = {"mild": (-2.0, 1.0), "strong": (1.0, 1.0), "model": (-6.0, 0.5)}[decay]
    r, k, v = (normal(b, t, h * n).view(b, t, h, n) for _ in range(3))
    logw = (-torch.exp(normal(b, t, h * n) * sd + mean)).view(b, t, h, n)
    u = normal(*((b, h, n) if u_per_batch else (h, n))) * 0.1
    s0 = normal(b, h, n, n) * 0.1 if random_s0 else torch.zeros(b, h, n, n, device="cuda")
    return r, k, v, logw, u, s0


def wkv_bound_ms(b, t, h, n):
    """Least time: r, k, v, logw read once, y written once, u, s0 and s_T,
    over HBM bandwidth; or 5 n^2 + 4 n fp32 operations per token and head
    (r.S; w S + k v; the bonus term; the exp) over the fp32 rate; or one exp
    per (token, head, row) over the special-function units' rate
    (H100_SFU_EXPS) (``kernels/work.py``'s formulas, which the dry-run's
    counter books too)."""
    from repro_torch.kernels.work import wkv_exps, wkv_ops

    nbytes = 4.0 * (5 * b * t * h * n + h * n + 2 * b * h * n * n)
    return ssm_bound_ms(nbytes, wkv_ops(b, t, h, n), wkv_exps(b, t, h, n))


# Path 7's shape: RWKV6-3B's prefill, batch 4 x 1024 tokens, 40 heads of 64
WKV_MAIN = dict(b=4, t=1024, h=40, n=64)


def phase_wkv_vs_plain(torch):
    """The rwkv6 kernel against its plain version over T, n and B * H in the
    reference's (BH, T, n) layout (through ``ops.wkv6``), mild and strong
    decay, odd widths, rows that are not contiguous (4-byte copies), path
    7's own shapes in the model's layout (views: RWKV6-3B's prefill, a decode
    step, B=1 at T=8192) and a split-T composition."""
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
    from repro_torch.kernels.rwkv6.ops import wkv6
    from repro_torch.kernels.rwkv6.ref import wkv6_heads_ref, wkv6_ref

    cases = [dict(bh=bh, t=t, n=n, decay=dec)
             for t in (1, 7, 64, 65, 1000) for n in (16, 32, 64)
             for bh in (1, 3, 160) for dec in ("mild", "strong")]
    cases += [dict(bh=3, t=65, n=n, decay="mild") for n in (5, 48)]
    cases += [dict(bh=bh, t=65, n=64, decay=dec, strided=True)
              for bh in (3, 160) for dec in ("mild", "strong")]
    err_y = err_s = 0.0
    for i, c in enumerate(cases):
        r, k, v, logw, u, s0 = wkv_inputs(torch, c["bh"], c["t"], 1, c["n"], seed=i,
                                          decay=c["decay"], u_per_batch=True)
        if c.get("strided"):          # entry stride T: the kernel's 4-byte copies
            r, k, v, logw = (a.transpose(1, 3).contiguous().transpose(1, 3)
                             for a in (r, k, v, logw))
        args = (r[:, :, 0], k[:, :, 0], v[:, :, 0], logw[:, :, 0], u[:, 0], s0[:, 0])
        y, s = wkv6(*args)
        torch.cuda.synchronize()
        ry, rs = wkv6_ref(*args)
        err_y = max(err_y, check_rows(torch, y, ry, (1, 2), f"rwkv6 y {c}"))
        err_s = max(err_s, check_rows(torch, s, rs, (1, 2), f"rwkv6 s_T {c}"))
    main = []
    for label, shape, dec, random_s0 in (
            ("prefill", WKV_MAIN, "model", False), ("prefill", WKV_MAIN, "strong", False),
            ("decode", dict(WKV_MAIN, t=1), "model", True),
            ("t8192", dict(WKV_MAIN, b=1, t=8192), "model", False),
            ("t8192", dict(WKV_MAIN, b=1, t=8192), "strong", False)):
        args = wkv_inputs(torch, **shape, seed=500, decay=dec, random_s0=random_s0)
        y, s = wkv6_cuda(*args)
        torch.cuda.synchronize()
        ry, rs = wkv6_heads_ref(*args)
        main.append([label, dec, check_rows(torch, y, ry, (1, 3), f"rwkv6 {label} y {dec}"),
                     check_rows(torch, s, rs, (2, 3), f"rwkv6 {label} s_T {dec}")])
        err_y, err_s = max(err_y, main[-1][2]), max(err_s, main[-1][3])
    # split-T composition at path 7's shape
    r, k, v, logw, u, s0 = wkv_inputs(torch, **WKV_MAIN, seed=501, decay="mild")
    y, s = wkv6_cuda(r, k, v, logw, u, s0)
    cut = 400
    y1, s1 = wkv6_cuda(r[:, :cut], k[:, :cut], v[:, :cut], logw[:, :cut], u, s0)
    y2, s2 = wkv6_cuda(r[:, cut:], k[:, cut:], v[:, cut:], logw[:, cut:], u, s1)
    torch.cuda.synchronize()
    err_split = max(check_rows(torch, torch.cat([y1, y2], 1), y, (1, 3), "rwkv6 split y"),
                    check_rows(torch, s2, s, (2, 3), "rwkv6 split s_T"))
    emit(phase="kernel_vs_plain", kernel="rwkv6", cases=len(cases) + len(main) + 1,
         tolerance=f"{SSM_TOL}*max(1,|ref|) of the (batch, head) row",
         max_abs_err_y=err_y, max_abs_err_s=err_s, max_abs_err_split_t=err_split,
         main_shape=WKV_MAIN, main_layout="(B, T, H, n) views of (B, T, H*n) tensors",
         main_results=[["shape", "decay", "y_err", "s_err"]] + main)
    torch.cuda.empty_cache()
    return max(err_y, err_s, err_split)


def phase_ssm_timings(torch, card):
    """Kernel, plain version and bound at path 7's shapes and at T=8192,
    the kernel timed call by call (``ms``, as every kernel here) and back to
    back (``ms_back_to_back``).  No one PyTorch call computes either
    function, so there is no library yardstick."""
    from repro_torch.kernels.mamba.kernel import launch_config as scan_config
    from repro_torch.kernels.mamba.kernel import selective_scan_cuda
    from repro_torch.kernels.mamba.ref import selective_scan_ref
    from repro_torch.kernels.rwkv6.kernel import launch_config as wkv_config
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
    from repro_torch.kernels.rwkv6.ref import wkv6_heads_ref

    rows = {}
    for label, b, t in (("hymba_prefill", 4, 2048), ("hymba_t8192", 1, 8192)):
        args = scan_inputs(torch, b, t, 1600, 16, seed=t, random_h0=False, model=True)
        ms = cuda_ms(torch, lambda: selective_scan_cuda(*args))
        back_to_back = cuda_ms_back_to_back(torch, lambda: selective_scan_cuda(*args))
        plain_ms = cuda_ms(torch, lambda: selective_scan_ref(*args), reps=3, warmup=1)
        bound, bound_by = scan_bound_ms(b, t, 1600, 16)
        rows[label] = dict(b=b, t=t, inner=1600, state=16, ms=ms,
                           ms_back_to_back=back_to_back, plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by, library_ms=None,
                           launch=scan_config(16, b, 1600))
        emit(phase="timing", kernel="mamba", shape=label, card=card, **rows[label],
             library_note=SSM_NO_LIBRARY)
    for label, b, t in (("rwkv6_prefill", 4, 1024), ("rwkv6_t8192", 1, 8192)):
        args = wkv_inputs(torch, b, t, 40, 64, seed=t, decay="model", random_s0=False)
        ms = cuda_ms(torch, lambda: wkv6_cuda(*args))
        back_to_back = cuda_ms_back_to_back(torch, lambda: wkv6_cuda(*args))
        plain_ms = cuda_ms(torch, lambda: wkv6_heads_ref(*args), reps=3, warmup=1)
        bound, bound_by = wkv_bound_ms(b, t, 40, 64)
        rows[label] = dict(b=b, t=t, h=40, n=64, ms=ms, ms_back_to_back=back_to_back,
                           plain_ms=plain_ms,
                           bound_ms=bound, bound_by=bound_by, library_ms=None,
                           launch=wkv_config(64, b * 40))
        emit(phase="timing", kernel="rwkv6", shape=label, card=card, **rows[label],
             library_note=SSM_NO_LIBRARY)
    # a decode step's call (B=4, T=1): the wrapper's host time, launch and
    # synchronise included, beside the kernel's time alone
    scan_args = scan_inputs(torch, 4, 1, 1600, 16, seed=1, model=True)
    wkv_args = wkv_inputs(torch, 4, 1, 40, 64, seed=1, decay="model")
    for kernel, fn, args in (("mamba", selective_scan_cuda, scan_args),
                             ("rwkv6", wkv6_cuda, wkv_args)):
        rows[f"{kernel}_decode"] = dict(
            b=4, t=1, ms=cuda_ms(torch, lambda: fn(*args)),
            ms_back_to_back=cuda_ms_back_to_back(torch, lambda: fn(*args)),
            host_us_per_call=host_us(torch, lambda: fn(*args)))
        emit(phase="timing", kernel=kernel, shape="decode_step", card=card,
             **rows[f"{kernel}_decode"])
    torch.cuda.empty_cache()
    return rows


def phase_ssm_serving_path(torch):
    """Path 7, SSM serving at full published width and depth (bf16): Hymba
    past its 1024 window, RWKV6-3B, and continuous batching on RWKV6-3B.
    Prefill launches each SSM kernel once per layer, and so does every
    decode step."""
    import numpy as np

    from repro_torch.configs import get_model_config
    from repro_torch.launch.scheduler import ContinuousBatcher, Request
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T

    reset_counts()                                # every count to 0
    runs = {}
    gen = 32
    for arch, prompt, ssm in (("hymba-1.5b", 2048, "mamba"), ("rwkv6-3b", 1024, "rwkv6")):
        cfg = get_model_config(arch)
        want = {ssm: cfg.n_layers * (1 + gen)}       # the prefill and every decode step
        if cfg.attention == "hybrid":
            want.update(flash_attention=cfg.n_layers, flash_attention_mma=cfg.n_layers)
        before = read_counts()
        torch.cuda.reset_peak_memory_stats()
        stats = serve(arch, smoke=False, batch=4, prompt_len=prompt, gen=gen,
                      verbose=False, device="cuda")
        launched = {k: n - before[k] for k, n in read_counts().items()}
        require(all(math.isfinite(v) and v > 0 for v in stats.values()), stats)
        require(launched == {k: want.get(k, 0) for k in launched},
                f"{arch}: launches {launched}, expected {want}")
        runs[arch] = launched
        emit(phase="serve", path="ssm_serving", model=arch, layers=cfg.n_layers,
             params=cfg.param_count(), batch=4, prompt=prompt, gen=gen, **stats,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9, launches=launched,
             ring_wraps=bool(cfg.window and prompt > cfg.window))
        torch.cuda.empty_cache()

    cfg = get_model_config("rwkv6-3b")
    params = T.init_params(0, cfg, "cuda")
    rng = np.random.default_rng(0)
    batcher = ContinuousBatcher(cfg, params, batch_slots=4, max_len=256, device="cuda")
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 129, size=8)]
    for i, p in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=p, max_new=16))
    before = read_counts()
    st = batcher.run()
    launched = {k: n - before[k] for k, n in read_counts().items()}
    require(st.completed == 8 and st.tokens_out == 8 * 16, st)
    require(all(len(r.out) == 16 and all(0 <= t < cfg.vocab_size for t in r.out)
                for r in batcher.completed))
    want = {"rwkv6": cfg.n_layers * st.decode_steps}
    require(launched == {k: want.get(k, 0) for k in launched},
            f"continuous batching: launches {launched}, expected {want}")
    runs["continuous_batching"] = launched
    counts = read_counts()                        # read just after
    emit(phase="serve", path="ssm_serving", model="rwkv6-3b", mode="continuous_batching",
         slots=4, requests=8, prompt_lens=[len(p) for p in prompts], max_new=16,
         completed=st.completed, decode_steps=st.decode_steps, tokens_out=st.tokens_out,
         elapsed_s=st.elapsed_s, tok_per_s=st.tok_per_s, mean_ttft_s=st.mean_ttft_s,
         mean_latency_s=st.mean_latency_s, launches=launched,
         note="prompts are fed token by token through decode, as in the "
              "reference: one rwkv6 launch per layer and decode step")
    emit(phase="main_launches", path="ssm_serving", launches=counts, per_run=runs)
    del params, batcher
    torch.cuda.empty_cache()
    return counts, runs


def phase_ssm_serve_profile(torch):
    """One serve call of each model (batch 4, its path-7 prompt, 4 new
    tokens; weights drawn inside the call) under torch.profiler."""
    from repro_torch.launch.serve import serve

    for arch, prompt, names in (("hymba-1.5b", 2048, ("selective_scan", "flash_fwd")),
                                ("rwkv6-3b", 1024, ("wkv6",))):
        wall, rows, dev_us, _ = device_profile(
            torch, lambda: serve(arch, smoke=False, batch=4, prompt_len=prompt, gen=4,
                                 verbose=False, device="cuda"))
        busy_s = sum(dev_us(e) for e in rows) / 1e6
        top = sorted(rows, key=dev_us, reverse=True)[:8]
        emit(phase="profile", path="ssm_serving", model=arch, wall_s=wall,
             device_kernels=sum(e.count for e in rows), device_busy_s=busy_s,
             device_idle_share=(1.0 - busy_s / wall) if busy_s else "not measured",
             port_kernels={k: v for n in names
                           for k, v in kernel_times(rows, dev_us, n).items()},
             top_device_ms=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])
        torch.cuda.empty_cache()


def phase_ssm_decode_profile(torch, batch=4, prompt=128, warm=3, profiled=4, steps=16,
                             layers=4):
    """Decode alone, Hymba-1.5B and RWKV6-3B at full width and depth cut to
    ``layers`` of their 32 (bf16, batch 4, after a 128-token prefill; the
    serving checks above run them whole): the serving loops' in-place step by
    the kernels (this tree's route), and the same step with the mixers'
    ops swapped for their plain versions (the route decode took before
    SSM decode went through the kernels), in turns.  Each window: 4 steps
    under torch.profiler (device kernels, SSM-kernel events and device
    busy ms per step; SSM-kernel launches per step from the wrappers'
    counters, which must be one a layer) and 16 unprofiled steps (wall ms
    per step, host clock around a final synchronise).  The profiler can
    lose events when a window holds ~39,000 kernels (one SSM event of 256
    and 105 others in one window on an H100), so its counts are reported
    and the launches are checked by the counters."""
    import dataclasses

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_model_config
    from repro_torch.kernels.mamba.ref import selective_scan_ref
    from repro_torch.kernels.rwkv6.ref import wkv6_heads_ref
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as T

    kernels = {"wkv6_heads": ssm_lib.wkv6_heads, "selective_scan": ssm_lib.selective_scan}
    plain = {"wkv6_heads": wkv6_heads_ref, "selective_scan": selective_scan_ref}
    out = {}
    for arch in ("hymba-1.5b", "rwkv6-3b"):
        cfg = dataclasses.replace(get_model_config(arch), n_layers=layers)
        params = T.init_params(0, cfg, "cuda")
        rng = np.random.default_rng(0)
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, prompt)), device="cuda")
        max_len = prompt + 4 * (warm + profiled + steps)
        logits, state = T.prefill(params, cfg, tok, impl="flash", last_only=True,
                                  max_len=max_len)
        nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        for route in ("kernels", "plain", "plain", "kernels"):
            for name, fn in (kernels if route == "kernels" else plain).items():
                setattr(ssm_lib, name, fn)
            try:
                for _ in range(warm):
                    logits, state = T._decode_step_into(params, cfg, state, nxt)
                torch.cuda.synchronize()
                before = read_counts()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(profiled):
                        logits, state = T._decode_step_into(params, cfg, state, nxt)
                    torch.cuda.synchronize()
                after = read_counts()
                t0 = time.perf_counter()
                for _ in range(steps):
                    logits, state = T._decode_step_into(params, cfg, state, nxt)
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0) / steps
            finally:
                for name, fn in kernels.items():
                    setattr(ssm_lib, name, fn)
            rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            busy_us = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
            ssm_rows = [e for e in rows if "wkv6" in e.key or "selective_scan" in e.key]
            ssm = sum(e.count for e in ssm_rows)
            require(bool(torch.isfinite(logits).all()), f"{arch} decode ({route}) not finite")
            out.setdefault(arch, {}).setdefault(route, []).append(dict(
                kernels_per_step=sum(e.count for e in rows) / profiled,
                ssm_kernel_launches_per_step=sum(after[k] - before[k]
                                                 for k in ("mamba", "rwkv6")) / profiled,
                ssm_kernel_events_per_step=ssm / profiled,
                ssm_kernel_device_ms_per_step=sum(
                    getattr(e, "self_device_time_total", 0.0) for e in ssm_rows) / 1e3 / profiled,
                device_busy_ms_per_step=busy_us / 1e3 / profiled, wall_ms_per_step=wall_ms))
        require(all(r["ssm_kernel_launches_per_step"] == cfg.n_layers
                    and r["ssm_kernel_events_per_step"] > 0
                    for r in out[arch]["kernels"])
                and all(r["ssm_kernel_launches_per_step"] == 0 for r in out[arch]["plain"]),
                f"{arch}: {out[arch]}")
        emit(phase="decode_profile", path="ssm_serving", model=arch, layers=layers,
             batch=batch, prompt=prompt, order="kernels, plain, plain, kernels",
             **out[arch])
        del params, state, logits
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# path 9: an LM as the FL global model
# ---------------------------------------------------------------------------

LM_FL = dict(arch="yi-6b", layers=2, n_devices=32, k=4, l_ep=1, batch=8, seq=64,
             seqs_per_device=16, test_seqs=16, lr=0.1)


def lm_fl_data(vocab, n_devices, per_device, seq, test, seed=0):
    """A token stream from ``make_lm_stream`` cut into (x, y) sequences of
    ``seq`` next-token pairs, ``per_device`` strided sequences a device and
    the last ``test`` as the test set."""
    import numpy as np

    from repro_torch.data import FederatedData, SyntheticClassificationDataset, make_lm_stream

    n_seq = n_devices * per_device + test
    stream = make_lm_stream(n_tokens=n_seq * (seq + 1) + 16, vocab=vocab, seed=seed)
    cut = np.asarray(stream[:n_seq * (seq + 1)]).reshape(n_seq, seq + 1)
    x, y = cut[:, :-1], cut[:, 1:]
    n_train = n_devices * per_device
    train = SyntheticClassificationDataset(x[:n_train], y[:n_train], vocab)
    held = SyntheticClassificationDataset(x[n_train:], y[n_train:], vocab)
    return FederatedData(train, held, [np.arange(i, n_train, n_devices)
                                      for i in range(n_devices)])


def bf16_ulp(torch, leaf) -> float:
    """One bf16 ulp at the leaf's largest magnitude: 2^(floor(log2 max|x|) - 7)."""
    top = float(leaf.float().abs().max())
    return 0.0 if top == 0 else 2.0 ** (math.floor(math.log2(top)) - 7)


# vmapped vs sequential LM round, bf16 leaves: two roundings may each move an
# entry by one ulp of itself (a client's SGD step from a differently rounded
# bf16 gradient, then fedavg's rounding of the fp32 mean), so two ulps at the
# leaf's largest magnitude
LM_FL_ULPS = 2


def ulp_diffs(torch, ref, got):
    """Each leaf's largest |difference| between two param trees, and the
    largest of them in units of its leaf's bf16 ulp (of EXEC_TOL for an fp32
    leaf)."""
    from repro_torch.fl._tree import tree_leaves

    diffs, tols = [], []
    for a, b in zip(tree_leaves(ref), tree_leaves(got)):
        diffs.append(float((a.float() - b.float()).abs().max()))
        tols.append(bf16_ulp(torch, a) if a.dtype == torch.bfloat16 else EXEC_TOL)
    worst = max(d / t if t else (0.0 if d == 0 else math.inf) for d, t in zip(diffs, tols))
    return diffs, worst


def phase_lm_fl_path(torch):
    """Path 9: Yi-6B at its full published width (d_model 4096, 32/4 heads of
    128, FFN 11008, vocab 64000, bf16, weights from a seed), depth cut to 2
    layers, as the FL global model: 32 devices, k=4, l_ep=1, local batch 8,
    sequences of 64 tokens.  One sync round of ``fedavg`` and one of
    ``fedrank`` (a fresh Q-net), each under the sequential and the vmapped
    executor in turns from the same init; the vmapped round must pick the
    sequential one's cohort, and its params lie within one bf16 ulp of each
    leaf's largest magnitude.  Then one FedRank round under torch.profiler."""
    import dataclasses

    from repro_torch.configs import get_model_config
    from repro_torch.fl import FLConfig, FLServer, LMTask, build_policy
    from repro_torch.fl._tree import tree_leaves
    from repro_torch.models import transformer as T

    c = LM_FL
    cfg = dataclasses.replace(get_model_config(c["arch"]), n_layers=c["layers"])
    data = lm_fl_data(cfg.vocab_size, c["n_devices"], c["seqs_per_device"], c["seq"],
                      c["test_seqs"])
    task = LMTask(cfg, seq_len=c["seq"])
    emit(phase="lm_fl_config", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         dtype=cfg.dtype, params=cfg.param_count(),
         gb_per_copy=2 * cfg.param_count() / 1e9,
         full_depth_gb_per_copy=2 * get_model_config(c["arch"]).param_count() / 1e9,
         note="full depth does not fit the vmapped executor's stacked copies and "
              "gradients of the 10-client probe cohort on one 80 GB card",
         **{k: v for k, v in c.items() if k not in ("arch", "layers")})
    reset_counts()                                # every count to 0
    steps = c["l_ep"] * (c["seqs_per_device"] // c["batch"])   # one bucket
    runs, servers = {}, {}
    for name in ("fedavg", "fedrank"):
        results = {}
        for ex in (("sequential", "vmapped") if name == "fedavg" else ("vmapped", "sequential")):
            fl = FLConfig(n_devices=c["n_devices"], k_select=c["k"], rounds=1,
                          l_ep=c["l_ep"], local_batch=c["batch"], lr=c["lr"], seed=0,
                          executor=ex)
            srv = FLServer(fl, task, data, device="cuda")
            sgd_launches = len(tree_leaves(srv.global_params)) * steps
            pol = (build_policy("fedrank", k=c["k"], seed=0) if name == "fedrank"
                   else build_policy("fedavg"))
            seen = checked_policy(pol, srv)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before, ckpt = read_counts(), T._checkpoint_layer.applied
            res = srv.run_round(pol)
            torch.cuda.synchronize()
            launched = {k: n - before[k] for k, n in read_counts().items()}
            check_round(srv, res, c["k"])
            require(len(seen) == 1 and math.isfinite(res.test_loss), (name, ex, res))
            want = 2 if name == "fedrank" else 0           # probe_set and select
            require(launched["select_topk"] == want, (name, ex, launched))
            # one update launch a leaf and step of the one bucket (the
            # sequential executor steps each client through _sgd_leaf)
            want_sgd = sgd_launches if ex == "vmapped" else 0
            require(launched["sgd_update"] == want_sgd, (name, ex, want_sgd, launched))
            require(all(l.dtype == torch.bfloat16 or l.dtype == torch.float32
                        for l in tree_leaves(srv.global_params)), "leaf dtypes")
            require(all(bool(torch.isfinite(l).all()) for l in tree_leaves(srv.global_params)),
                    (name, ex, "non-finite params"))
            results[ex] = dict(cohort=res.selected.tolist(), probe=res.probe_set.tolist(),
                               test_loss=res.test_loss, host_s=res.host_time_s,
                               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                               layer_checkpoints=T._checkpoint_layer.applied - ckpt,
                               launches=launched)
            servers[(name, ex)] = (srv, pol)
        s_seq, s_vm = servers[(name, "sequential")][0], servers[(name, "vmapped")][0]
        diffs, worst = ulp_diffs(torch, s_seq.global_params, s_vm.global_params)
        require(results["sequential"]["cohort"] == results["vmapped"]["cohort"]
                and results["sequential"]["probe"] == results["vmapped"]["probe"],
                (name, results))
        require(worst <= LM_FL_ULPS, (name, "vmapped params off", max(diffs), worst))
        runs[name] = dict(results, max_param_diff=max(diffs), max_diff_in_ulps=worst)
        emit(phase="lm_fl", policy=name,
             tolerance=f"vmapped vs sequential: per bf16 leaf {LM_FL_ULPS} bf16 ulps "
                       "at the leaf's largest magnitude (one ulp = "
                       "2^(floor(log2 max|x|)-7)); fp32 leaves 1e-5 (as ulps of 1)",
             **runs[name])
        for ex in ("sequential", "vmapped"):
            if name == "fedavg":
                del servers[(name, ex)]
        torch.cuda.empty_cache()
    # one more FedRank round of the vmapped server under torch.profiler
    srv, pol = servers[("fedrank", "vmapped")]
    del servers[("fedrank", "sequential")]
    torch.cuda.empty_cache()
    before = read_counts()
    prof = profile_summary(torch, lambda: srv.run_round(pol))
    launched = {k: n - before[k] for k, n in read_counts().items()}
    require(launched["select_topk"] == 2 and launched["sgd_update"] == sgd_launches,
            (sgd_launches, launched))
    counts = read_counts()                        # read just after
    emit(phase="profile", path="lm_fl", policy="fedrank", executor="vmapped",
         sgd_update_launches_per_round=sgd_launches, leaves=sgd_launches // steps,
         steps=steps,
         host_s=srv.history[-1].host_time_s, launches=launched, **prof)
    emit(phase="main_launches", path="lm_fl", launches=counts)
    del servers, srv
    torch.cuda.empty_cache()
    return counts, runs


# lm_fl_remat: Yi-6B at its published width, depth cut to 4 layers (path 10's,
# 1.22 B parameters), as the FL global model over 512-token sequences: 8
# devices of 8 sequences, so a fedavg round's k clients make one bucket and
# take one grad step of the local batch
LM_FL_REMAT = dict(LM_FL, layers=4, n_devices=8, seq=512, seqs_per_device=8, test_seqs=8)


def layer_saved_bytes(cfg, b, s) -> int:
    """The bytes autograd saves for one dense GQA layer (RMSNorm, RoPE, naive
    attention, a gated FFN; bf16 weights) over one client's batch of b
    sequences of s tokens, counted from the shapes.  Each norm: its input,
    the scaled input and its output (bf16, t x d), the input in fp32, the
    (t, 1) fp32 sum and bf16 inverse, the bf16 scale.  RoPE: cos and sin
    (t x Dh/2, fp32) for q and for k.  Attention: q, k and v in fp32 for the
    two einsums, the (s, s) bool mask, the fp32 probabilities twice (the
    softmax's output and the combine's contiguous copy) and the bf16 output
    that ``wo`` reads.  FFN: the gate, its activation, the up projection and
    their product (t x d_ff, bf16)."""
    t, d, e = b * s, cfg.d_model, 2                 # tokens, width, bf16 bytes
    norm = t * d * 4 + t * 4 + t * e + 3 * t * d * e + d * e
    rope = 4 * t * (cfg.head_dim // 2) * 4
    attn = (t * cfg.q_dim * 4 + 2 * t * cfg.kv_dim * 4 + s * s
            + 2 * b * cfg.n_heads * s * s * 4 + t * cfg.q_dim * e)
    ffn = 4 * t * cfg.d_ff * e
    return 2 * norm + rope + attn + ffn


def measured_saved_bytes(torch, cfg, params, b, s) -> int:
    """The bytes plain autograd saves for layer 0 over one client's (b, s)
    batch: distinct storages through ``saved_tensors_hooks``, the weights
    aside."""
    from torch.utils._pytree import tree_leaves, tree_map

    from repro_torch.models import transformer as T

    # weights that require grad, as in training: a product saves its other
    # operand only for an operand that needs a gradient
    lp = tree_map(lambda t: t.detach().requires_grad_(True), T.layer_params(params["layers"], 0))
    weights = {t.untyped_storage().data_ptr() for t in tree_leaves(lp)}
    x = torch.randn(b, s, cfg.d_model, device="cuda").to(getattr(torch, cfg.dtype))
    x.requires_grad_(True)
    held = []

    # the nodes keep nothing (a saved output packed into its own node would
    # make a cycle that outlives the call; the graph never runs backward);
    # the list keeps every saved tensor alive until counted, so no storage's
    # address is reused by another
    with torch.autograd.graph.saved_tensors_hooks(held.append, lambda _: None):
        T._seq_layer(cfg, "naive", x, lp)
    sizes = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes() for t in held}
    held.clear()
    return sum(n for ptr, n in sizes.items() if ptr not in weights)


def phase_lm_fl_remat(torch):
    """Path 9's ``lm_fl_remat``: ``cfg.remat`` under the vmapped executor.
    Yi-6B at its published width (bf16, weights from a seed), 4 layers, as
    the FL global model: 8 devices, k=4, l_ep=1, local batch 8, 512-token
    sequences.  One ``fedavg`` round with ``remat=True`` and one with
    ``remat=False`` from the same init, in turns (on, off, off, on): the
    same cohort, every param leaf within LM_FL_ULPS bf16 ulps, a finite test
    loss, the layer checkpoint applied ``n_layers`` times a grad step with
    remat and never without, and the remat round's own peak (the peak over
    the memory held when it starts) below the plain round's by at least
    half the activations predicted from the shapes: one layer's saved
    tensors (:func:`layer_saved_bytes`) x (L - 1) layers x k clients."""
    import dataclasses

    from repro_torch.configs import get_model_config
    from repro_torch.fl import FLConfig, FLServer, LMTask, build_policy
    from repro_torch.models import transformer as T

    c = LM_FL_REMAT
    base = dataclasses.replace(get_model_config(c["arch"]), n_layers=c["layers"])
    data = lm_fl_data(base.vocab_size, c["n_devices"], c["seqs_per_device"], c["seq"],
                      c["test_seqs"])
    steps = c["l_ep"] * c["seqs_per_device"] // c["batch"]     # grad steps a round
    per_layer = layer_saved_bytes(base, c["batch"], c["seq"])
    predicted = per_layer * (base.n_layers - 1) * c["k"]
    reset_counts()                                # every count to 0
    runs, kept, init = {True: [], False: []}, {}, None
    for remat in (True, False, False, True):
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
        ckpt = T._checkpoint_layer.applied
        res = srv.run_round(build_policy("fedavg"))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        applied = T._checkpoint_layer.applied - ckpt
        check_round(srv, res, c["k"])
        require(len(res.selected) == c["k"], ("lm_fl_remat cohort", res.selected))
        require(applied == (cfg.n_layers * steps if remat else 0),
                ("layer checkpoints", remat, applied, steps))
        runs[remat].append(dict(cohort=res.selected.tolist(), test_loss=res.test_loss,
                                host_s=res.host_time_s, peak_memory_gb=peak / 1e9,
                                round_peak_gb=(peak - held) / 1e9, layer_checkpoints=applied))
        kept.setdefault(remat, srv.global_params)
        del srv
        torch.cuda.empty_cache()
    cohorts = {tuple(r["cohort"]) for rs in runs.values() for r in rs}
    require(len(cohorts) == 1, ("lm_fl_remat cohorts", runs))
    diffs, worst = ulp_diffs(torch, kept[False], kept[True])
    require(worst <= LM_FL_ULPS, ("remat params off", max(diffs), worst))
    on_gb = max(r["round_peak_gb"] for r in runs[True])
    off_gb = min(r["round_peak_gb"] for r in runs[False])
    saved_gb = off_gb - on_gb
    require(saved_gb * 1e9 >= predicted / 2,
            ("remat saves too little", on_gb, off_gb, predicted / 1e9))
    measured = measured_saved_bytes(torch, base, init, c["batch"], c["seq"])
    counts = read_counts()                        # read just after
    emit(phase="lm_fl_remat", model=base.name, layers=base.n_layers, params=base.param_count(),
         executor="vmapped", policy="fedavg", steps_per_round=steps,
         **{k: v for k, v in c.items() if k not in ("arch", "layers")},
         saved_bytes_one_layer_predicted=per_layer,
         saved_bytes_one_layer_measured=measured,
         predicted_activation_gb=predicted / 1e9,
         remat_on=runs[True], remat_off=runs[False],
         round_peak_gb_on=on_gb, round_peak_gb_off=off_gb, saved_gb=saved_gb,
         max_param_diff=max(diffs), max_diff_in_ulps=worst,
         tolerance=f"remat on vs off: every leaf within {LM_FL_ULPS} bf16 ulps at its "
                   "largest magnitude; the saving at least half the prediction")
    emit(phase="main_launches", path="lm_fl_remat", launches=counts)
    del kept, init
    torch.cuda.empty_cache()
    return counts


def phase_cpu_agreement_lm_fl(torch):
    """One LM FL round (yi-6b smoke, fp32, 8 devices, k=2, sequences of 16)
    on the CPU and on the card from the same weights: the same cohort, params
    within CPU_CARD_TOL."""
    from repro_torch.configs import get_model_config
    from repro_torch.fl import FLConfig, FLServer, LMTask, build_policy
    from repro_torch.fl._tree import tree_leaves

    cfg = get_model_config("yi-6b", smoke=True)
    data = lm_fl_data(cfg.vocab_size, 8, 28, 16, 32)
    out, init = {}, None
    for dev in ("cpu", "cuda"):
        fl = FLConfig(n_devices=8, k_select=2, rounds=1, l_ep=1, lr=0.3, seed=0)
        srv = FLServer(fl, LMTask(cfg, seq_len=16), data, device=dev)
        if init is None:
            init = (srv.global_params, srv._last_acc)
        else:
            srv.global_params, srv._last_acc = tree_to(init[0], dev), init[1]
        res = srv.run_round(build_policy("fedavg"))
        out[dev] = (res.selected.tolist(), [l.cpu() for l in tree_leaves(srv.global_params)],
                    res.test_loss)
    err = max(float((a - b).abs().max()) for a, b in zip(out["cpu"][1], out["cuda"][1]))
    require(out["cpu"][0] == out["cuda"][0], ("LM FL cohorts", out["cpu"][0], out["cuda"][0]))
    require(err <= CPU_CARD_TOL and math.isfinite(out["cuda"][2]), ("LM FL params", err))
    emit(phase="cpu_vs_card", run="lm_fl/yi-6b-smoke", cohort=out["cuda"][0],
         max_abs_param_err=err, tolerance=CPU_CARD_TOL)


# ---------------------------------------------------------------------------
# path 10: LM training
# ---------------------------------------------------------------------------

# Yi-6B at its published width, depth cut to 4 layers (1.22 B parameters:
# 2.43 GB of bf16 params, 9.73 GB of fp32 moments, about 27 GB at the
# functional update's peak); full depth (6.06 B) needs 72.7 GB before the
# update's copies.  lr: 3e-4, the peak of the reference's make_optimizer
LM_TRAIN = dict(arch="yi-6b", layers=4, batch=4, seq=1024, steps=20, lr=3e-4,
                smoke=False)
LM_TRAIN_SSM = dict(archs=("hymba-1.5b", "rwkv6-3b"), layers=2, batch=2, seq=512,
                    steps=3, lr=3e-4)
# naive vs blocked attention at step 1, bf16: both compute the attention in
# fp32 and round its output to bf16 once; where the two round an entry to
# neighbouring bf16 values, everything downstream moves by that ulp.  The
# loss within 2^-7 relative (one bf16 ulp of the logits), every gradient
# within 2^-5 of its leaf's largest magnitude (a few such ulps, summed)
TRAIN_ROUTE_LOSS_TOL = 2 ** -7
TRAIN_ROUTE_GRAD_TOL = 2 ** -5
CPU_CARD_TRAIN_TOL = 1e-4    # smoke configs, fp32: fp32 sums in another order


_STREAMS: dict = {}          # vocab -> make_lm_stream's tokens (1 s each to make)


def train_batches(cfg, batch, seq, device, seed=0):
    """``lm_batches`` over ``make_lm_stream``, as ``launch/train.py`` draws them."""
    from repro_torch.data import make_lm_stream
    from repro_torch.launch.train import lm_batches

    if cfg.vocab_size not in _STREAMS:
        _STREAMS[cfg.vocab_size] = make_lm_stream(n_tokens=1 << 17, vocab=cfg.vocab_size,
                                                  seed=0)
    return lm_batches(_STREAMS[cfg.vocab_size], batch, seq, seed, device)


def train_recipe(lr, steps):
    """``launch/train.py``'s optimizer."""
    from repro_torch.optim import adamw, linear_warmup_cosine

    return adamw(linear_warmup_cosine(lr, steps // 10, steps), weight_decay=0.01,
                 grad_clip=1.0)


def recording(torch, opt, seen):
    """``opt`` whose update first records the step's gradients and the peak
    memory of the forward and backward (once: the first step)."""
    from repro_torch.optim import Optimizer

    def update(grads, params, state):
        if not seen:
            seen.append((grads, torch.cuda.max_memory_allocated()))
        return opt.update(grads, params, state)

    return Optimizer(opt.init, update)


def leaf_errors(torch, got, want):
    """Largest |got - want| of each leaf over its largest |want|."""
    from repro_torch.fl._tree import tree_leaves

    out = []
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        scale = float(b.float().abs().max())
        out.append(float((a.float() - b.float()).abs().max()) / (scale or 1.0))
    return out


def run_train(torch, cfg, params, impl, steps, lr, batch, seq):
    """``steps`` train steps from ``params`` (left as they are), synchronised
    after each for its time (the batch's draw and upload included): losses,
    ms per step, step 1's gradients and forward-and-backward peak, the
    step's peak memory."""
    from repro_torch.launch.steps import make_train_step

    seen = []
    step = make_train_step(cfg, recording(torch, train_recipe(lr, steps), seen), impl=impl)
    opt = train_recipe(lr, steps).init(params)
    batches = train_batches(cfg, batch, seq, "cuda")
    p, losses, ms = params, [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(steps):
        t0 = time.perf_counter()
        p, opt, metrics = step(p, opt, next(batches))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(metrics["loss"])
    losses = torch.stack(losses).tolist()
    require(all(math.isfinite(v) for v in losses), (cfg.name, impl, losses))
    return dict(losses=losses, ms=ms, grads=seen[0][0], fwd_bwd_peak_gb=seen[0][1] / 1e9,
                step_peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def phase_cpu_agreement_lm_train(torch):
    """(a) Smoke configs in fp32 (yi-6b under impl="naive" and "blocked",
    hymba and rwkv6 under "blocked"): 3 ``make_train_step`` steps on the CPU
    and on the card from the same weights and the same ``lm_batches``, with
    the step's default optimizer (``make_optimizer``): losses, step 1's
    gradients (over each leaf's largest magnitude) and the final params
    within CPU_CARD_TRAIN_TOL."""
    from repro_torch.configs import get_model_config
    from repro_torch.fl._tree import tree_leaves
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import transformer as T

    for arch, impl in (("yi-6b", "naive"), ("yi-6b", "blocked"), ("hymba-1.5b", "blocked"),
                       ("rwkv6-3b", "blocked")):
        cfg = get_model_config(arch, smoke=True)
        init = T.init_params(0, cfg, "cpu")
        out = {}
        for dev in ("cpu", "cuda"):
            seen = []
            opt = make_optimizer(3)
            step = make_train_step(cfg, recording(torch, opt, seen), impl=impl)
            p, st = tree_to(init, dev), opt.init(tree_to(init, dev))
            batches = train_batches(cfg, 4, 64, dev)
            losses = []
            for _ in range(3):
                p, st, m = step(p, st, next(batches))
                losses.append(float(m["loss"]))
            out[dev] = (losses, [t.cpu() for t in tree_leaves(seen[0][0])],
                        [t.cpu() for t in tree_leaves(p)], int(st["step"]))
        (lc, gc, pc, sc), (lg, gg, pg, sg) = out["cpu"], out["cuda"]
        loss_err = max(abs(a - b) for a, b in zip(lc, lg))
        grad_err = max(leaf_errors(torch, gg, gc))
        param_err = max(float((a - b).abs().max()) for a, b in zip(pc, pg))
        require(sc == sg == 3 and loss_err <= CPU_CARD_TRAIN_TOL
                and grad_err <= CPU_CARD_TRAIN_TOL and param_err <= CPU_CARD_TRAIN_TOL,
                (arch, impl, loss_err, grad_err, param_err))
        emit(phase="cpu_vs_card", run=f"lm_train/{arch}-smoke/{impl}", steps=3,
             losses_card=lg, max_abs_loss_err=loss_err, max_grad_err_over_leaf_max=grad_err,
             max_abs_param_err=param_err, tolerance=CPU_CARD_TRAIN_TOL)


def phase_lm_train_path(torch):
    """Path 10, LM training (``make_train_step``, ``launch/train.py``):

    (b) Yi-6B at its published width (d 4096, 32/4 heads of 128, d_ff
    11008, vocab 64000), depth cut to 4 layers, bf16, ``remat=True`` (the
    config's own), batch 4 x 1024 tokens from ``make_lm_stream``, AdamW with
    ``linear_warmup_cosine`` (lr 3e-4): 20 steps under ``impl="naive"`` and
    20 from the same init under ``"blocked"``; every loss finite and the
    last below the first; step 1's loss and gradients of the two routes
    within TRAIN_ROUTE_*_TOL; one step with remat on and off from the same
    params (equal loss, gradients within one bf16 ulp at each leaf's largest
    magnitude; peak memory of each); ms per step, tokens/s, the model FLOP
    rate (6 N tokens/s against the bf16 peak) and one step under
    torch.profiler.
    (c) Hymba-1.5B and RWKV6-3B at full width, 2 layers, bf16, batch 2 x
    512, 3 steps each under ``"blocked"``: finite losses, ms per step.
    (d) Every kernel counter stays 0 across the path; with params that
    require grad, a forward through ``impl="flash"`` and the ``"cuda"`` SSM
    routes raises.
    (e) ``save_pytree``/``load_pytree`` of a bf16 smoke train state from the
    card reloads bit-equal with its dtypes; ``latest_checkpoint`` picks the
    highest step.
    (f) ``train()`` on the card reduces the loss."""
    import dataclasses

    from repro_torch.configs import get_model_config
    from repro_torch.fl._tree import tree_leaves
    from repro_torch.models import transformer as T

    c = LM_TRAIN
    full = get_model_config(c["arch"], smoke=c["smoke"])
    cfg = dataclasses.replace(full, n_layers=c["layers"])
    n_params = cfg.param_count()
    tokens = c["batch"] * c["seq"]
    emit(phase="lm_train_config", model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
         heads=cfg.n_heads, kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, dtype=cfg.dtype, remat=cfg.remat, params=n_params,
         param_gb=2 * n_params / 1e9, moment_gb=8 * n_params / 1e9,
         full_depth_params=full.param_count(),
         note="full depth: bf16 params, gradients and fp32 moments alone take "
              f"{12 * full.param_count() / 1e9:.1f} GB before the update's copies",
         **{k: v for k, v in c.items() if k not in ("arch", "layers")})
    reset_counts()                                # every count to 0
    params = T.init_params(0, cfg, "cuda")
    runs = {}
    for impl in ("naive", "blocked"):
        runs[impl] = run_train(torch, cfg, params, impl, c["steps"], c["lr"], c["batch"],
                               c["seq"])
        r = runs[impl]
        require(r["losses"][-1] < r["losses"][0], (impl, r["losses"]))
        steady = statistics.median(r["ms"][1:])
        _PATH10[f"{impl}_ms"] = steady
        emit(phase="lm_train", model=cfg.name, impl=impl, steps=c["steps"],
             losses=r["losses"], ms_per_step_median=steady, ms_first_step=r["ms"][0],
             ms_per_step=r["ms"], tokens_per_s=tokens / (steady / 1e3),
             model_tflops=6 * n_params * tokens / (steady / 1e3) / 1e12,
             model_flop_share_of_bf16_peak=6 * n_params * tokens / (steady / 1e3)
             / H100_BF16_FLOPS,
             fwd_bwd_peak_gb=r["fwd_bwd_peak_gb"], step_peak_gb=r["step_peak_gb"])
        torch.cuda.empty_cache()
    (gn, gb) = runs["naive"]["grads"], runs["blocked"]["grads"]
    l_n, l_b = runs["naive"]["losses"][0], runs["blocked"]["losses"][0]
    route_grad = leaf_errors(torch, gb, gn)
    require(abs(l_n - l_b) <= TRAIN_ROUTE_LOSS_TOL * abs(l_n)
            and max(route_grad) <= TRAIN_ROUTE_GRAD_TOL, (l_n, l_b, route_grad))
    emit(phase="lm_train_routes", model=cfg.name, step1_loss_naive=l_n,
         step1_loss_blocked=l_b, max_grad_err_over_leaf_max=max(route_grad),
         tolerance=f"loss {TRAIN_ROUTE_LOSS_TOL} relative, gradients "
                   f"{TRAIN_ROUTE_GRAD_TOL} of each leaf's largest magnitude")
    del runs, gn, gb
    torch.cuda.empty_cache()

    # remat on and off, one step each from the same params
    remat = {}
    for on in (True, False):
        r = run_train(torch, dataclasses.replace(cfg, remat=on), params, "naive", 1,
                      c["lr"], c["batch"], c["seq"])
        remat[on] = r
        torch.cuda.empty_cache()
    ulps = [bf16_ulp(torch, b) for b in tree_leaves(remat[False]["grads"])]
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in
             zip(tree_leaves(remat[True]["grads"]), tree_leaves(remat[False]["grads"]))]
    require(remat[True]["losses"] == remat[False]["losses"]
            and all(d <= u for d, u in zip(diffs, ulps)), (remat[True]["losses"],
                                                           remat[False]["losses"], diffs))
    emit(phase="lm_train_remat", model=cfg.name, impl="naive",
         loss_on=remat[True]["losses"][0], loss_off=remat[False]["losses"][0],
         grads_bit_equal=max(diffs) == 0.0, max_abs_grad_diff=max(diffs),
         fwd_bwd_peak_gb_remat=remat[True]["fwd_bwd_peak_gb"],
         fwd_bwd_peak_gb_no_remat=remat[False]["fwd_bwd_peak_gb"],
         step_peak_gb_remat=remat[True]["step_peak_gb"],
         step_peak_gb_no_remat=remat[False]["step_peak_gb"],
         ms_remat=remat[True]["ms"][0], ms_no_remat=remat[False]["ms"][0])
    del remat
    torch.cuda.empty_cache()

    # one step under torch.profiler (naive, remat), after a warm step
    from repro_torch.launch.steps import make_train_step

    step = make_train_step(cfg, train_recipe(c["lr"], c["steps"]), impl="naive")
    opt = train_recipe(c["lr"], c["steps"]).init(params)
    batches = train_batches(cfg, c["batch"], c["seq"], "cuda")
    p, opt, _ = step(params, opt, next(batches))
    b = next(batches)
    wall, rows, dev_us, _ = device_profile(torch, lambda: step(p, opt, b))
    busy_s = sum(dev_us(e) for e in rows) / 1e6
    top = sorted(rows, key=dev_us, reverse=True)[:10]
    emit(phase="profile", path="lm_train", model=cfg.name, impl="naive", wall_s=wall,
         device_kernels=sum(e.count for e in rows), device_busy_s=busy_s,
         device_idle_share=(1.0 - busy_s / wall) if busy_s else "not measured",
         top_device_ms=[[e.key[:70], dev_us(e) / 1e3, e.count] for e in top])
    del step, opt, p, b, params
    torch.cuda.empty_cache()

    # (c) the SSM families at full width, 2 layers
    s = LM_TRAIN_SSM
    for arch in s["archs"]:
        scfg = dataclasses.replace(get_model_config(arch, smoke=c["smoke"]),
                                   n_layers=s["layers"])
        sparams = T.init_params(0, scfg, "cuda")
        r = run_train(torch, scfg, sparams, "blocked", s["steps"], s["lr"], s["batch"],
                      s["seq"])
        emit(phase="lm_train", model=scfg.name, layers=scfg.n_layers, dtype=scfg.dtype,
             remat=scfg.remat, params=scfg.param_count(), impl="blocked",
             batch=s["batch"], seq=s["seq"], losses=r["losses"], ms_per_step=r["ms"],
             step_peak_gb=r["step_peak_gb"])
        del sparams, r
        torch.cuda.empty_cache()

    # (d) the kernels' routes refuse to train
    phase_train_refusals(torch)
    # (e) checkpoints of a smoke train state from the card
    phase_train_checkpoints(torch)
    # (f) the driver
    phase_train_driver(torch)
    counts = read_counts()                        # read just after
    require(all(n == 0 for n in counts.values()), ("a kernel launched in training", counts))
    emit(phase="main_launches", path="lm_train", launches=counts)
    return counts


def phase_train_refusals(torch):
    """With params that require grad, a forward through the kernel routes
    raises before any launch: ``impl="flash"`` for yi-6b, hymba and rwkv6,
    and the ``"cuda"`` SSM mixers alone (smoke configs, fp32)."""
    from repro_torch.configs import get_model_config
    from repro_torch.fl._tree import tree_leaves
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as T

    before = read_counts()
    refused = []
    for arch in ("yi-6b", "hymba-1.5b", "rwkv6-3b"):
        cfg = get_model_config(arch, smoke=True)
        params = T.init_params(0, cfg, "cuda")
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        tok = torch.zeros((2, 64), dtype=torch.int64, device="cuda")
        calls = [("forward/flash", lambda: T.forward(params, cfg, tok, impl="flash"))]
        lp = T.layer_params(params["layers"], 0)
        x = torch.randn((2, 64, cfg.d_model), device="cuda")
        if arch == "hymba-1.5b":
            st = ssm_lib.init_mamba_state(cfg, 2, x.device)
            calls.append(("mamba_scan/cuda",
                          lambda: ssm_lib.mamba_scan(lp["mamba"], x, st, cfg, impl="cuda")))
        if arch == "rwkv6-3b":
            st = ssm_lib.init_rwkv_state(cfg, 2, x.device)
            calls.append(("rwkv_time_mix_chunked/cuda",
                          lambda: ssm_lib.rwkv_time_mix_chunked(lp["time_mix"], x, st, cfg,
                                                                impl="cuda")))
        for name, fn in calls:
            try:
                fn()
            except ValueError as e:
                require("has no backward" in str(e), (arch, name, e))
                refused.append(f"{arch}:{name}")
            else:
                raise RuntimeError(f"chip_smoke: {arch} {name} trained through a kernel")
    require(read_counts() == before, "a refused call launched a kernel")
    emit(phase="lm_train_refusals", refused=refused)


def phase_train_checkpoints(torch):
    """A bf16 yi-6b smoke train state after one step on the card:
    ``save_pytree`` then ``load_pytree`` gives the same bits and dtypes;
    ``latest_checkpoint`` picks the highest of three steps."""
    import dataclasses
    import shutil

    from repro_torch.checkpoint import latest_checkpoint, load_pytree, save_pytree
    from repro_torch.configs import get_model_config
    from repro_torch.fl._tree import tree_leaves
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_model_config("yi-6b", smoke=True), dtype="bfloat16")
    params = T.init_params(0, cfg, "cuda")
    opt = make_optimizer(10)
    state = opt.init(params)
    params, state, _ = make_train_step(cfg, opt)(params, state,
                                                next(train_batches(cfg, 4, 64, "cuda")))
    tree = {"params": params, "opt": state}
    root = ROOT / "build" / "ckpt"
    shutil.rmtree(root, ignore_errors=True)
    paths = [str(root / f"step_{s}.ckpt") for s in (1, 12, 3)]
    t0 = time.perf_counter()
    for path in paths:
        save_pytree(tree, path)
    save_s = (time.perf_counter() - t0) / len(paths)
    back = load_pytree(paths[1])
    want, got = tree_leaves(tree), tree_leaves(back)
    require(len(want) == len(got) and all(
        a.dtype == b.dtype and a.shape == b.shape and b.device.type == "cpu"
        and torch.equal(a.cpu(), b) for a, b in zip(want, got)), "checkpoint round trip")
    require(latest_checkpoint(str(root)) == paths[1], latest_checkpoint(str(root)))
    emit(phase="lm_train_checkpoint", model=cfg.name, dtype=cfg.dtype,
         leaves=len(got), bytes=Path(paths[1]).stat().st_size, save_s=save_s,
         dtypes=sorted({str(t.dtype) for t in got}), latest=Path(paths[1]).name)
    shutil.rmtree(root, ignore_errors=True)


def phase_train_driver(torch):
    """``train()`` on the card, smoke config: the issue's short run (40
    steps, batch 4, seq 64) reported, and 200 steps of batch 8 held to a
    lower loss: the mean of the last ten losses below that of the first ten
    (on this stream a batch's loss moves by a few 1e-2 from one batch to the
    next, more than 40 steps move it)."""
    from repro_torch.launch.train import train

    t0 = time.perf_counter()
    short = train("yi-6b", smoke=True, steps=40, batch=4, seq=64, verbose=False,
                  device="cuda")
    short_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hist = train("yi-6b", smoke=True, steps=200, batch=8, seq=64, log_every=1,
                 verbose=False, device="cuda")
    long_s = time.perf_counter() - t0
    loss = hist["loss"]
    first, last = statistics.fmean(loss[:10]), statistics.fmean(loss[-10:])
    require(all(math.isfinite(v) for v in loss) and last < first, (first, last))
    emit(phase="lm_train_driver", model="yi-6b-smoke", short_run_losses=short["loss"],
         short_run_s=short_s, steps=200, batch=8, seq=64, first10_mean=first,
         last10_mean=last, seconds=long_s, tokens_per_s=hist["tokens_per_s"][-1])


# ---------------------------------------------------------------------------
# path 11: the rest of the zoo (MoE, whisper's encoder-decoder, the VLM)
# ---------------------------------------------------------------------------

# Serving at the published widths, bf16: (arch, depth or None for full
# depth, batch, prompt tokens, new tokens).  Depth is cut where the weights
# would not leave room on one 80 GB card: phi3.5-moe (41.9 B parameters) to
# 4 of 32 layers (5.46 B), internvl2-76b (70.6 B) to 2 of 80 (3.81 B).
# InternVL2's prompt is its 256 image tokens and 768 text tokens; whisper's
# a 32-token prompt over 1500 encoder frames.
ZOO_SERVE = (("olmoe-1b-7b", None, 4, 1024, 32), ("phi3.5-moe", 4, 4, 1024, 32),
             ("whisper-medium", None, 4, 32, 32), ("internvl2-76b", 2, 4, 768, 32))
# Training, bf16, remat, 3 steps on one batch (the loss must fall): (arch,
# depth, batch, text tokens, optimizer).  AdamW takes ~32 bytes a
# parameter at its peak (path 10: 38.8 GB for Yi-6B's 1.22 B), so
# internvl2-76b's one layer (2.96 B, 2.10 B of them its embedding and head)
# takes SGD with momentum (14 bytes a parameter).
ZOO_TRAIN = (("olmoe-1b-7b", 4, 4, 1024, "adamw"), ("phi3.5-moe", 1, 4, 1024, "adamw"),
             ("whisper-medium", None, 4, 1024, "adamw"), ("internvl2-76b", 1, 2, 512, "sgd"))
ZOO_ADAMW_LR = 3e-4          # the peak of the reference's make_optimizer
ZOO_SGD_LR = 1e-2
ZOO_ARCHS = ("olmoe-1b-7b", "phi3.5-moe", "whisper-medium", "internvl2-76b")
MOE_SORT_DENSE_TOL = 1e-5    # lossless sort vs dense dispatch, fp32 (the reference test's)


def zoo_cfg(arch, layers, smoke=False):
    import dataclasses

    from repro_torch.configs import get_model_config

    cfg = get_model_config(arch, smoke=smoke)
    return cfg if layers is None else dataclasses.replace(cfg, n_layers=layers)


def frontend_embeds(torch, cfg, batch, device, seed=0):
    """Random frontend embeddings in the config's dtype (the frontends are
    stubs): whisper's frames or the VLM's image tokens; None otherwise."""
    from repro_torch.models.transformer import torch_dtype

    if cfg.frontend is None:
        return None
    n = cfg.enc_seq if cfg.enc_dec else cfg.frontend.n_tokens
    gen = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn((batch, n, cfg.frontend.embed_dim), generator=gen).to(
        device=device, dtype=torch_dtype(cfg.dtype))


@contextlib.contextmanager
def moe_prefill_drops():
    """Record ``dropped_fraction`` of every MoE call over more than one
    position (the prefill's; decode routes one token a sequence)."""
    from repro_torch.models import moe

    seen, apply = [], moe.apply_moe

    def recorded(p, x, cfg):
        y, aux = apply(p, x, cfg)
        if x.shape[1] > 1:
            seen.append(aux["dropped_fraction"])
        return y, aux

    moe.apply_moe = recorded
    try:
        yield seen
    finally:
        moe.apply_moe = apply


def phase_cpu_agreement_zoo(torch):
    """Smoke configs in fp32, the same weights and inputs on the CPU and the
    card: ``forward`` (naive), ``prefill`` (the kernels' route) and 8 decode
    steps, and the ``loss_fn`` gradients (the blocked route) of the four
    families, within LM_TOL (logits, aux) and CPU_CARD_TRAIN_TOL (each
    gradient over its leaf's largest magnitude); the MoE's sort dispatch
    against the dense one on the card (lossless: within
    MOE_SORT_DENSE_TOL, dropped 0); one ``LMTask`` FedRank round of
    olmoe-smoke under both executors on both devices: one cohort, params
    within CPU_CARD_TOL."""
    import dataclasses

    import numpy as np

    from repro_torch.fl._tree import tree_leaves, tree_unflatten
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as T

    for arch in ZOO_ARCHS:
        cfg = zoo_cfg(arch, None, smoke=True)
        params = T.init_params(0, cfg, "cpu")
        prompt, n = 24, 32
        tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, n))
        fe_cpu = frontend_embeds(torch, cfg, 2, "cpu", seed=1)
        out = {}
        for dev in ("cpu", "cuda"):
            p = tree_to(params, dev)
            t = torch.as_tensor(tok, device=dev)
            fe = None if fe_cpu is None else fe_cpu.to(dev)
            full, aux = T.forward(p, cfg, t, fe)
            logits, st = T.prefill(p, cfg, t[:, :prompt], fe, max_len=n + 8, impl="flash")
            steps = [logits.cpu()]
            for i in range(prompt, n):
                lg, st = T.decode_step(p, cfg, st, t[:, i])
                steps.append(lg.cpu())
            live = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(p)]
            batch = {"tokens": t, "labels": t.roll(-1, 1), "frontend_embeds": fe}
            loss, _ = T.loss_fn(tree_unflatten(p, live), cfg, batch, impl="blocked")
            grads = torch.autograd.grad(loss, live)
            out[dev] = ([full.cpu(), aux.cpu()] + steps, [g.cpu() for g in grads],
                        float(loss))
        logit_err = max(float((a - b).abs().max()) for a, b in zip(out["cpu"][0],
                                                                    out["cuda"][0]))
        grad_err = max(leaf_errors(torch, out["cuda"][1], out["cpu"][1]))
        require(logit_err <= LM_TOL and grad_err <= CPU_CARD_TRAIN_TOL,
                (arch, logit_err, grad_err))
        emit(phase="cpu_vs_card", model=cfg.name, prompt=prompt, decode_steps=n - prompt,
             frontend=None if fe_cpu is None else list(fe_cpu.shape),
             aux_card=float(out["cuda"][0][1]), loss_card=out["cuda"][2],
             max_abs_logit_err=logit_err, max_grad_err_over_leaf_max=grad_err,
             tolerance={"logits": LM_TOL, "grads": CPU_CARD_TRAIN_TOL})

    # the sort dispatch against the dense one on the card
    errs = {}
    for groups in (1, 2, 4):
        base = zoo_cfg("olmoe-1b-7b", None, smoke=True)
        cfg_s = dataclasses.replace(base, moe=dataclasses.replace(base.moe, n_groups=groups))
        cfg_d = dataclasses.replace(base, moe=dataclasses.replace(base.moe, dispatch="dense"))
        gen = torch.Generator(device="cuda").manual_seed(groups)
        p = moe_lib.init_moe(gen, cfg_s, torch.float32)
        x = torch.randn((2, 32, base.d_model), generator=gen, device="cuda")
        ys, aux_s = moe_lib.apply_moe(p, x, cfg_s)
        yd, aux_d = moe_lib.apply_moe(p, x, cfg_d)
        errs[groups] = float((ys - yd).abs().max())
        require(float(aux_s["dropped_fraction"]) == 0.0
                and errs[groups] <= MOE_SORT_DENSE_TOL, ("moe sort vs dense", groups, errs))
    emit(phase="moe_sort_vs_dense", device="cuda", max_abs_err_by_groups=errs,
         tolerance=MOE_SORT_DENSE_TOL)

    # one LMTask FedRank round of olmoe-smoke, both executors, both devices
    from repro_torch.fl import FLConfig, FLServer, LMTask, build_policy

    cfg = zoo_cfg("olmoe-1b-7b", None, smoke=True)
    data = lm_fl_data(cfg.vocab_size, 8, 28, 16, 32)
    res, init = {}, None
    for ex in ("sequential", "vmapped"):
        for dev in ("cpu", "cuda"):
            fl = FLConfig(n_devices=8, k_select=2, rounds=1, l_ep=1, lr=0.3, seed=0,
                          executor=ex)
            srv = FLServer(fl, LMTask(cfg, seq_len=16), data, device=dev)
            if init is None:
                init = (srv.global_params, srv._last_acc)
            else:
                srv.global_params, srv._last_acc = tree_to(init[0], dev), init[1]
            r = srv.run_round(build_policy("fedrank", k=2, seed=0, device=dev))
            res[(ex, dev)] = (r.selected.tolist(),
                              [l.cpu() for l in tree_leaves(srv.global_params)], r.test_loss)
    cohorts = {f"{ex}/{dev}": v[0] for (ex, dev), v in res.items()}
    err = max(max(float((a - b).abs().max()) for a, b in zip(res[(ex, "cpu")][1],
                                                             res[(ex, "cuda")][1]))
              for ex in ("sequential", "vmapped"))
    require(len({tuple(c) for c in cohorts.values()}) == 1, ("MoE FL cohorts", cohorts))
    require(err <= CPU_CARD_TOL and all(math.isfinite(v[2]) for v in res.values()),
            ("MoE FL params", err))
    emit(phase="cpu_vs_card", run="lm_fl/olmoe-1b-7b-smoke/fedrank", cohorts=cohorts,
         max_abs_param_err=err, tolerance=CPU_CARD_TOL)


def phase_zoo_serving(torch):
    """Serving at the published widths in bf16 through ``serve()`` (prefill
    by ``impl="flash"``, then ``gen`` decode steps), each model alone with
    every count at 0 before it: one ``flash_attention`` launch a layer
    (whisper: 24 bidirectional over its 1500 frames and 24 causal), every
    one on the tensor-core kernel; then a ``ContinuousBatcher`` on
    olmoe-1b-7b at full depth (4 slots, 8 requests, prompts of 16-64
    tokens, 8 new tokens each; no attention kernel: prompts go through
    decode).  Prints prefill s, decode tokens/s, the peak memory and the
    MoE prefill's dropped fraction (the mean over its layers)."""
    import numpy as np

    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.launch.scheduler import ContinuousBatcher, Request
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T

    reset_counts()                                # every count to 0
    runs = {}
    for arch, layers, batch, prompt, gen in ZOO_SERVE:
        cfg = zoo_cfg(arch, layers)
        want = cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)
        before = read_counts()
        torch.cuda.reset_peak_memory_stats()
        with moe_prefill_drops() as drops:
            stats = serve(arch, smoke=False, batch=batch, prompt_len=prompt, gen=gen,
                          verbose=False, device="cuda", layers=layers)
        launched = {k: n - before[k] for k, n in read_counts().items()}
        require(all(math.isfinite(v) and v > 0 for v in stats.values()), (arch, stats))
        require(launched["flash_attention"] == want
                and launched["flash_attention_mma"] == want,
                (arch, "flash launches", launched, want))
        require(sum(n for k, n in launched.items() if not k.startswith("flash")) == 0,
                (arch, launched))
        dropped = [float(d) for d in drops]
        require(len(dropped) == (cfg.n_layers if cfg.moe else 0), (arch, len(dropped)))
        runs[arch] = launched["flash_attention"]
        emit(phase="serve", path="zoo_serving", model=arch, layers=cfg.n_layers,
             enc_layers=cfg.n_enc_layers if cfg.enc_dec else None,
             params=cfg.param_count(), batch=batch, prompt=prompt, gen=gen,
             frontend_tokens=(cfg.enc_seq if cfg.enc_dec else cfg.frontend.n_tokens)
             if cfg.frontend else None, **stats,
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             flash_attention_launches=launched["flash_attention"],
             flash_attention_mma_launches=launched["flash_attention_mma"],
             moe_prefill_dropped_fraction=statistics.fmean(dropped) if dropped else None,
             moe_prefill_dropped_by_layer=dropped or None)
        torch.cuda.empty_cache()

    cfg = zoo_cfg("olmoe-1b-7b", None)
    params = T.init_params(0, cfg, "cuda")
    rng = np.random.default_rng(0)
    batcher = ContinuousBatcher(cfg, params, batch_slots=4, max_len=128, device="cuda")
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(16, 65, size=8)]
    for i, p in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=p, max_new=8))
    before = read_counts()
    st = batcher.run()
    launched = {k: n - before[k] for k, n in read_counts().items()}
    require(st.completed == 8 and st.tokens_out == 8 * 8, st)
    require(all(len(r.out) == 8 and all(0 <= t < cfg.vocab_size for t in r.out)
                for r in batcher.completed))
    require(all(n == 0 for n in launched.values()), ("batcher launched", launched))
    runs["continuous_batching"] = launched["flash_attention"]
    counts = read_counts()                        # read just after
    emit(phase="serve", path="zoo_serving", model=cfg.name, mode="continuous_batching",
         slots=4, requests=8, prompt_lens=[len(p) for p in prompts], max_new=8,
         completed=st.completed, decode_steps=st.decode_steps, tokens_out=st.tokens_out,
         elapsed_s=st.elapsed_s, tok_per_s=st.tok_per_s, mean_ttft_s=st.mean_ttft_s,
         mean_latency_s=st.mean_latency_s, flash_attention_launches=launched["flash_attention"])
    emit(phase="main_launches", path="zoo_serving", launches=counts, per_run=runs)
    del params, batcher
    torch.cuda.empty_cache()
    return counts, runs


def phase_zoo_train(torch):
    """3 ``make_train_step`` steps (the default ``blocked`` route,
    ``remat=True``) of each model at its published width in bf16, on one
    batch from ``lm_batches`` (so the loss must fall from step 1 to step 3),
    whisper and the VLM with frontend embeddings in the batch (whisper's
    encoder and cross-attention run their backward); the MoE models' aux
    must be nonzero.  ms a step and the peak memory.  No kernel launches:
    training takes the plain routes."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.optim import sgd

    before = read_counts()
    rows = {}
    for arch, layers, batch, seq, opt_name in ZOO_TRAIN:
        cfg = zoo_cfg(arch, layers)
        require(cfg.remat and cfg.dtype == "bfloat16", cfg.name)
        opt = (train_recipe(ZOO_ADAMW_LR, 3) if opt_name == "adamw"
               else sgd(ZOO_SGD_LR, momentum=0.9))
        params = T.init_params(0, cfg, "cuda")
        state = opt.init(params)
        b = next(train_batches(cfg, batch, seq, "cuda"))
        fe = frontend_embeds(torch, cfg, batch, "cuda")
        if fe is not None:
            b["frontend_embeds"] = fe
        step = make_train_step(cfg, opt)
        losses, auxes, ms = [], [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
            auxes.append(float(m["aux"]))
        peak = torch.cuda.max_memory_allocated() / 1e9
        require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
                (arch, losses))
        require((min(auxes) > 0) if cfg.moe else (max(auxes) == 0), (arch, auxes))
        rows[arch] = dict(layers=cfg.n_layers, params=cfg.param_count(), losses=losses,
                          aux=auxes, ms_per_step=ms, peak_memory_gb=peak)
        emit(phase="lm_train", path="zoo_train", model=arch, layers=cfg.n_layers,
             enc_layers=cfg.n_enc_layers if cfg.enc_dec else None, dtype=cfg.dtype,
             remat=cfg.remat, impl="blocked", optimizer=opt_name,
             lr=ZOO_ADAMW_LR if opt_name == "adamw" else ZOO_SGD_LR,
             batch=batch, seq=seq, frontend=None if fe is None else list(fe.shape),
             params=cfg.param_count(), losses=losses, aux=auxes, ms_per_step=ms,
             step_peak_gb=peak)
        del params, state, b, fe, step
        torch.cuda.empty_cache()
    launched = {k: n - before[k] for k, n in read_counts().items()}
    require(all(n == 0 for n in launched.values()), ("a kernel launched in training",
                                                      launched))
    return rows


def named_leaves(tree, prefix=""):
    """{"layers/moe/router": tensor, ...} in ``tree_leaves`` order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(named_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# Path 9's MoE round: olmoe-1b-7b at its published width (64 experts, top 8),
# depth cut to 1 layer (0.63 B parameters), with path 9's fleet and data
LM_FL_MOE = dict(LM_FL, arch="olmoe-1b-7b", layers=1)


def phase_lm_fl_moe(torch):
    """One FedRank round (a fresh Q-net) of olmoe-1b-7b as the FL global
    model under the sequential and the vmapped executor from one init: the
    same cohort and probe set, every leaf within LM_FL_ULPS bf16 ulps at
    its largest magnitude (the fp32 router and norms too: they train from
    bf16 activations), exactly 2 ``select_topk`` launches a round; host s
    and peak memory."""
    import dataclasses

    from repro_torch.configs import get_model_config
    from repro_torch.fl import FLConfig, FLServer, LMTask, build_policy

    c = LM_FL_MOE
    cfg = dataclasses.replace(get_model_config(c["arch"]), n_layers=c["layers"])
    data = lm_fl_data(cfg.vocab_size, c["n_devices"], c["seqs_per_device"], c["seq"],
                      c["test_seqs"])
    task = LMTask(cfg, seq_len=c["seq"])
    reset_counts()                                # every count to 0
    results, servers, init = {}, {}, None
    for ex in ("sequential", "vmapped"):          # one init: the same seed
        fl = FLConfig(n_devices=c["n_devices"], k_select=c["k"], rounds=1, l_ep=c["l_ep"],
                      local_batch=c["batch"], lr=c["lr"], seed=0, executor=ex)
        srv = FLServer(fl, task, data, device="cuda")
        if init is None:                          # the fp32 leaves' init, for their update
            init = {k: v.clone() for k, v in named_leaves(srv.global_params).items()
                    if v.dtype == torch.float32}
        pol = build_policy("fedrank", k=c["k"], seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = read_counts()
        res = srv.run_round(pol)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in read_counts().items()}
        check_round(srv, res, c["k"])
        require(launched["select_topk"] == 2 and math.isfinite(res.test_loss),
                (ex, launched, res.test_loss))
        results[ex] = dict(cohort=res.selected.tolist(), probe=res.probe_set.tolist(),
                           test_loss=res.test_loss, host_s=res.host_time_s,
                           peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                           launches=launched)
        servers[ex] = srv
    leaves = {}                                   # name -> (diff, unit, diff / unit)
    seq = named_leaves(servers["sequential"].global_params)
    vm = named_leaves(servers["vmapped"].global_params)
    for name, a in seq.items():
        d = float((a.float() - vm[name].float()).abs().max())
        unit = bf16_ulp(torch, a)
        leaves[name] = (d, unit, d / unit if unit else (0.0 if d == 0 else math.inf))
    worst = max(r[2] for r in leaves.values())
    # the fp32 leaves' round updates, beside their differences
    fp32_updates = {n: [float((seq[n] - t).abs().max()), leaves[n][0]]
                    for n, t in init.items()}
    counts = read_counts()                        # read just after
    emit(phase="lm_fl", policy="fedrank", model=cfg.name, layers=cfg.n_layers,
         experts=cfg.moe.n_experts, top_k=cfg.moe.top_k, params=cfg.param_count(),
         **results, max_param_diff=max(r[0] for r in leaves.values()),
         max_diff_in_ulps=worst,
         worst_leaves=sorted(([n] + list(r) for n, r in leaves.items()),
                             key=lambda r: -r[3])[:4],
         fp32_leaf_update_and_diff=fp32_updates,
         tolerance=f"vmapped vs sequential: every leaf within {LM_FL_ULPS} bf16 ulps at "
                   "its largest magnitude, the fp32 ones (the router, the norms) too: "
                   "their gradients come through bf16 activations, and the router's "
                   "sums 512 tokens' terms a step that nearly cancel")
    require(results["sequential"]["cohort"] == results["vmapped"]["cohort"]
            and results["sequential"]["probe"] == results["vmapped"]["probe"], results)
    require(worst <= LM_FL_ULPS, ("MoE vmapped params off", worst))
    emit(phase="main_launches", path="lm_fl_moe", launches=counts)
    del servers
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def phase_obs(torch, data):
    """Observed runs at paths 1 and 5's sizes (1000 devices, k=10): sync
    FedRank rounds on ``high-churn`` and async FedRank aggregations on
    ``trace-synthetic-week``, each beside the same run unobserved, in turns
    (host s per round or aggregation with and without the recorder, whose
    timings fence every executor and kernel op).  The records go to
    ``build/obs/``; the port's ``check_run`` passes (span coverage >= 0.5),
    and the op table lists ``executor.*``, ``select_topk.cuda`` and
    ``fleet_state.cuda``.  One more observed round runs inside a
    ``trace_gate`` block, which writes a Chrome trace."""
    import shutil

    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy
    from repro_torch.fl.async_engine import AsyncRoundEngine
    from repro_torch.obs import clear_profiler, trace_gate
    from repro_torch.obs.report import check_run, coverage, load_run, op_table

    root = ROOT / "build" / "obs"
    shutil.rmtree(root, ignore_errors=True)
    out, ops = {}, {}
    reset_counts()
    for label, scenario, mode in (("sync", "high-churn", "sync"),
                                  ("async", "trace-synthetic-week", "async")):
        kw = (dict(mode="async", async_concurrency=30, staleness="polynomial")
              if mode == "async" else {})
        runs = {}
        for observed in (False, True):
            cfg = FLConfig(n_devices=1000, k_select=10, rounds=3, l_ep=5, scenario=scenario,
                           observe=str(root / label) if observed else None, **kw)
            srv = FLServer(cfg, MLPTask(), data, device="cuda")
            if scenario.startswith("trace"):
                start_before_first_change(srv)
            pol = build_policy("fedrank", k=10, seed=0)
            runs[observed] = dict(srv=srv, pol=pol, host_s=[],
                                  eng=AsyncRoundEngine(srv, pol) if mode == "async" else None)
        for r in range(3):
            for observed in ((False, True) if r % 2 == 0 else (True, False)):
                run = runs[observed]
                if mode == "sync":
                    res = run["srv"].run_round(run["pol"])
                    check_round(run["srv"], res, 10)
                else:
                    res = run["eng"].run(1)[-1]
                    check_async_history(torch, run["srv"], [res], 10)
                run["host_s"].append(res.host_time_s)
        obs_srv = runs[True]["srv"]
        require(runs[False]["srv"].obs.enabled is False, "unobserved run has a recorder")
        trace_bytes = None
        if mode == "sync":
            with trace_gate(str(root / "trace")) as path:
                run_res = obs_srv.run_round(runs[True]["pol"])
                check_round(obs_srv, run_res, 10)
            trace_bytes = Path(path).stat().st_size
            require(trace_bytes > 0, "empty Chrome trace")
        obs_srv.obs.close()
        clear_profiler(obs_srv.obs)
        _, rounds, events = load_run(str(root / label))
        problems = check_run(rounds)
        require(not problems, (label, problems))
        table = op_table(rounds)
        ops[label] = {row["op"]: [row["n"], row["wall_s"]] for row in table}
        out[label] = dict(rounds=len(rounds), events=len(events),
                          coverage=coverage(rounds),
                          host_s_unobserved=runs[False]["host_s"],
                          host_s_observed=runs[True]["host_s"],
                          spans=sorted({s["span"] for r in rounds for s in r["spans"]}),
                          ops=ops[label], chrome_trace_bytes=trace_bytes)
        emit(phase="obs", run=f"{label}/{scenario}/fedrank", **out[label])
        del runs, obs_srv
    every = {name for table in ops.values() for name in table}
    require(any(n.startswith("executor.") for n in every)
            and {"select_topk.cuda", "fleet_state.cuda"} <= every, sorted(every))
    require(all(ops[k][n][1] > 0 for k in ops for n in ops[k]), "an op without time")
    counts = read_counts()
    emit(phase="main_launches", path="obs", launches=counts)
    return out


# ---------------------------------------------------------------------------
# Path 12: the mesh tooling (DeviceMesh, DTensor layouts, the dry-run)
# ---------------------------------------------------------------------------

MESH_MODELS = (("yi-6b", 2), ("rwkv6-3b", 2), ("hymba-1.5b", 2))
MESH_PREFILL = dict(batch=4, prompt=1024, decode=8)
MESH_TRAIN = dict(arch="yi-6b", layers=2, batch=4, seq=1024, steps=3)
# the dry-runs, each a process of its own (a fake 256-rank group is the
# default group there): the production mesh's combinations (Hymba's prefill
# at full depth and width through the kernel ops; RWKV6's smoke train step,
# whose batch of 8 is smaller than the data axis), path 10's Yi-6B step on
# a 1x1 mesh for the counter's roofline terms, and path 6's Yi-6B prefill
# (4 x 1024, full depth) through the kernel ops on a 1x1 mesh
MESH_DRYRUNS = {
    "yi-6b/train_4k": ["--arch", "yi-6b", "--shape", "train_4k"],
    "olmoe-1b-7b/decode_32k": ["--arch", "olmoe-1b-7b", "--shape", "decode_32k"],
    "path10_step": ["--arch", "yi-6b", "--shape", "train_4k", "--mesh", "1x1",
                    "--layers", str(LM_TRAIN["layers"]), "--batch", str(LM_TRAIN["batch"]),
                    "--seq", str(LM_TRAIN["seq"])],
    "hymba-1.5b/prefill_32k/flash": ["--arch", "hymba-1.5b", "--shape", "prefill_32k",
                                     "--impl", "flash"],
    "rwkv6-3b/train_4k/smoke": ["--arch", "rwkv6-3b", "--shape", "train_4k", "--smoke"],
    "path6_prefill/flash": ["--arch", "yi-6b", "--shape", "prefill_32k", "--mesh", "1x1",
                            "--batch", "4", "--seq", "1024", "--impl", "flash"],
}
# the kernel ops a flash dry-run must go through: (op, calls a layer)
MESH_DRYRUN_KERNELS = {
    "hymba-1.5b/prefill_32k/flash": {"repro_torch::flash_attention": 1,
                                     "repro_torch::selective_scan": 1},
    "path6_prefill/flash": {"repro_torch::flash_attention": 1},
}
_PATH10: dict = {}           # path 10's measured ms a step, when it ran first
_PATH6: dict = {}            # serve()'s Yi-6B prefill seconds in path 6, when it ran first


def start_dryruns():
    """Start every MESH_DRYRUNS process at once; (name -> (process, out path))."""
    import os

    out_dir = ROOT / "build" / "dryrun"
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {}
    for name, argv in MESH_DRYRUNS.items():
        out = out_dir / (name.replace("/", "_") + ".json")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out", str(out)],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), out)
    return procs


def mesh_run(torch, cfg, params, tokens, n_decode, mesh=None, rules=None):
    """Prefill of ``tokens`` by the kernels (``impl="flash"``) and
    ``n_decode`` decode steps (the SSM kernels), as DTensors under ``rules``
    on ``mesh`` or as plain tensors: (every step's logits as plain tensors,
    the launch counts, host ms a decode step)."""
    from repro_torch.launch.sharding import (
        P,
        decode_state_specs,
        distribute_params,
    )
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import use_logical_rules

    def plain(x):
        return x.full_tensor() if hasattr(x, "full_tensor") else x

    b, s = tokens.shape[0], tokens.shape[1] - n_decode
    ctx = use_logical_rules(mesh, rules) if mesh is not None else contextlib.nullcontext()
    reset_counts()                                # every count to 0
    with torch.no_grad(), ctx:
        prompt = tokens[:, :s]
        if mesh is not None:
            prompt = distribute_params(prompt, mesh, P(rules["batch"], None))
        logits, state = T.prefill(params, cfg, prompt, max_len=s + n_decode, impl="flash",
                                  last_only=True)
        if mesh is not None:
            from repro_torch.configs import ShapeConfig

            shape = ShapeConfig("mesh", s + n_decode, b, "decode")
            state = distribute_params(state, mesh, decode_state_specs(cfg, state, mesh, shape))
        out, step_ms = [plain(logits[:, 0])], []
        for i in range(n_decode):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tok = tokens[:, s + i]
            if mesh is not None:
                tok = distribute_params(tok, mesh, P(rules["batch"]))
            lg, state = T._decode_step_into(params, cfg, state, tok)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            out.append(plain(lg))
    # the first step carries the process's first-use costs
    return out, read_counts(), statistics.median(step_ms[1:])


def phase_mesh_models(torch, mesh):
    """(a) Yi-6B, RWKV6-3B and Hymba-1.5B at full width, 2 layers, bf16, on
    the 1x1 mesh: params laid out by ``param_specs`` and placed by
    ``distribute_params``; prefill 4 x 1024 by the kernels (on each rank's
    local shards through ``local_map``) and 8 decode steps, against the same
    run on plain tensors: logits within one bf16 ulp at each step's largest
    magnitude, the same launches, host ms a decode step of each (the
    median of steps 2..8, each synchronised)."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_model_config
    from repro_torch.launch.sharding import build_rules, distribute_params, param_specs
    from repro_torch.models import transformer as T

    c = MESH_PREFILL
    counts, out = {}, {}
    for arch, layers in MESH_MODELS:
        cfg = dataclasses.replace(get_model_config(arch), n_layers=layers)
        params = T.init_params(0, cfg, "cuda")
        g = torch.Generator(device="cuda").manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (c["batch"], c["prompt"] + c["decode"]),
                               device="cuda", generator=g)
        want, want_n, plain_ms = mesh_run(torch, cfg, params, tokens, c["decode"])
        rules = build_rules(cfg, mesh, ShapeConfig("mesh", c["prompt"] + c["decode"],
                                                   c["batch"], "decode"))
        dp = distribute_params(params, mesh, param_specs(cfg, params, mesh, "decode"))
        got, got_n, dt_ms = mesh_run(torch, cfg, dp, tokens, c["decode"], mesh, rules)
        errs = [float((a.float() - w.float()).abs().max()) for a, w in zip(got, want)]
        ulps = [bf16_ulp(torch, w) for w in want]
        require(all(e <= u for e, u in zip(errs, ulps)), (arch, errs, ulps))
        require(got_n == want_n and any(n > 0 for k, n in got_n.items()),
                (arch, got_n, want_n))
        counts[arch] = got_n
        out[arch] = dict(plain_ms=plain_ms, dtensor_ms=dt_ms)
        emit(phase="mesh_serve", model=arch, layers=layers, dtype=cfg.dtype,
             batch=c["batch"], prompt=c["prompt"], decode_steps=c["decode"],
             max_logit_err=max(errs), bf16_ulps=ulps, launches=got_n,
             launches_plain=want_n, host_ms_per_decode_step_plain=plain_ms,
             host_ms_per_decode_step_dtensor=dt_ms,
             dtensor_added_host_ms_per_decode_step=dt_ms - plain_ms)
        del params, dp, want, got
        torch.cuda.empty_cache()
    return counts, out


def phase_mesh_train(torch, mesh):
    """(a) 3 ``make_train_step`` steps of Yi-6B (full width, 2 layers,
    bf16, ``impl="blocked"``, 4 x 1024) on the 1x1 mesh (train-mode specs,
    the optimizer state placed like the params) against the same steps on
    plain tensors: each loss within one bf16 ulp; no kernel launches."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_model_config
    from repro_torch.launch.sharding import P, build_rules, distribute_params, param_specs
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import use_logical_rules

    c = MESH_TRAIN
    cfg = dataclasses.replace(get_model_config(c["arch"]), n_layers=c["layers"])
    params = T.init_params(0, cfg, "cuda")
    batches = list(zip(range(c["steps"]), train_batches(cfg, c["batch"], c["seq"], "cuda")))
    rules = build_rules(cfg, mesh, ShapeConfig("mesh", c["seq"], c["batch"], "train"))
    pspec = param_specs(cfg, params, mesh, "train")
    reset_counts()                                # every count to 0
    losses, ms = {}, {}
    for route in ("plain", "dtensor"):
        opt = make_optimizer()
        step = make_train_step(cfg, opt, impl="blocked")
        p, st = params, opt.init(params)
        ctx = contextlib.nullcontext()
        if route == "dtensor":
            p = distribute_params(params, mesh, pspec)
            st = distribute_params(st, mesh, {"mu": pspec, "nu": pspec, "step": P()})
            ctx = use_logical_rules(mesh, rules)
        losses[route], ms[route] = [], []
        with ctx:
            for _, batch in batches:
                if route == "dtensor":
                    batch = distribute_params(batch, mesh, {k: P(rules["batch"], None)
                                                            for k in batch})
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p, st, m = step(p, st, batch)
                loss = m["loss"]
                losses[route].append(float(loss.full_tensor() if hasattr(loss, "full_tensor")
                                           else loss))
                ms[route].append(1e3 * (time.perf_counter() - t0))
        del p, st
        torch.cuda.empty_cache()
    ulps = [2.0 ** (math.floor(math.log2(abs(v))) - 7) for v in losses["plain"]]
    errs = [abs(a - b) for a, b in zip(losses["dtensor"], losses["plain"])]
    require(all(e <= u for e, u in zip(errs, ulps)), (losses, ulps))
    counts = read_counts()
    require(all(n == 0 for n in counts.values()), ("a kernel launched in training", counts))
    emit(phase="mesh_train", model=cfg.name, layers=c["layers"], impl="blocked",
         batch=c["batch"], seq=c["seq"], losses_plain=losses["plain"],
         losses_dtensor=losses["dtensor"], max_loss_err=max(errs), bf16_ulps=ulps,
         ms_per_step_plain=ms["plain"], ms_per_step_dtensor=ms["dtensor"], launches=counts)


def phase_mesh_fl(torch, mesh, data):
    """(b) One path-1 FedRank round (1000 devices, k=10, the MLP, the
    vmapped executor) with ``mesh=`` the 1x1 mesh and with ``mesh=None``
    from identical servers: equal probe sets and cohorts, params within
    1e-6; host s of each."""
    from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy
    from repro_torch.fl.engine import VmappedExecutor

    cfg = FLConfig(n_devices=1000, k_select=10, rounds=1, l_ep=5, scenario="high-churn",
                   executor="vmapped")
    res, srvs = {}, {}
    for name, m in (("mesh", mesh), ("no_mesh", None)):
        srv = FLServer(cfg, MLPTask(), data, executor=VmappedExecutor(mesh=m), device="cuda")
        r = srv.run_round(build_policy("fedrank", k=10))
        check_round(srv, r, cfg.k_select)
        res[name], srvs[name] = r, srv
    a, b = res["mesh"], res["no_mesh"]
    diff = params_diff(srvs["mesh"].global_params, srvs["no_mesh"].global_params)
    require(a.selected.tolist() == b.selected.tolist()
            and sorted(a.probe_set) == sorted(b.probe_set) and diff <= 1e-6,
            (a.selected.tolist(), b.selected.tolist(), diff))
    emit(phase="mesh_fl", policy="fedrank", n_devices=cfg.n_devices, k=cfg.k_select,
         cohort=a.selected.tolist(), params_max_abs_diff=diff,
         host_s_mesh=a.host_time_s, host_s_no_mesh=b.host_time_s)


def phase_mesh_dryruns(torch, procs):
    """(c) and (d): every dry-run process's record; ``ok`` each, its
    per-device FLOPs, bytes and wire bytes, seconds and roofline row; for
    path 10's step on the 1x1 mesh, the compute and memory terms beside the
    ms path 10 measured (or 5 steps measured here when it did not run); for
    path 6's Yi-6B prefill through the kernel ops on the 1x1 mesh, the terms
    beside that prefill measured here after a warm-up (and serve()'s first
    call in path 6, when it ran).  The flash dry-runs must go through their
    kernel ops, one call a layer."""
    from repro_torch.configs import get_model_config
    from repro_torch.launch.roofline import row_from_record

    recs = {}
    for name, (proc, out) in procs.items():
        log = proc.communicate(timeout=600)[0]
        require(proc.returncode == 0 and out.is_file(), f"dry-run {name}: {log[-2000:]}")
        rec = json.loads(out.read_text())[0]
        require(rec["status"] == "ok", (name, rec.get("error")))
        # the counter's per-device FLOPs of a sharded MLP, exact on this torch
        check = rec["counter_check"]
        require(check["dot_flops"] == check["expected"], (name, check))
        if name in MESH_DRYRUN_KERNELS:        # one kernel op call a layer
            layers = get_model_config(rec["arch"], smoke=rec["smoke"]).n_layers
            want = {op: n * layers for op, n in MESH_DRYRUN_KERNELS[name].items()}
            require(rec["hlo"]["kernel_calls"] == want,
                    (name, rec["hlo"]["kernel_calls"], want))
        row = row_from_record(rec)
        recs[name] = (rec, row)
        emit(phase="mesh_dryrun", run=name, arch=rec["arch"], shape=rec["shape"],
             impl=rec["impl"], smoke=rec["smoke"], cut=rec.get("cut"),
             mesh=rec["mesh"], chips=rec["chips"],
             kernel_calls=rec["hlo"]["kernel_calls"],
             seconds=rec["seconds"], flops_per_device=rec["hlo"]["flops_per_device"],
             dot_flops_per_device=rec["hlo"]["dot_flops_per_device"],
             bytes_per_device=rec["hlo"]["bytes_per_device"],
             collective_wire_bytes=rec["hlo"]["collective_wire_bytes"],
             collective_wire_bytes_by_axis=rec["hlo"]["collective_wire_bytes_by_axis"],
             collective_bytes=rec["hlo"]["collective_bytes"], memory=rec["memory"],
             not_measured=rec["not_measured"], roofline=row.as_dict(), counter_check=check,
             log_tail=log.strip().splitlines()[-1][:300])
    rec, row = recs["path10_step"]
    step_ms = _PATH10.get("blocked_ms") or measure_path10_step(torch)
    roof_ms = 1e3 * max(row.compute_s, row.memory_s)
    emit(phase="mesh_roofline_vs_card", model="yi-6b", layers=LM_TRAIN["layers"],
         batch=LM_TRAIN["batch"], seq=LM_TRAIN["seq"], impl="blocked",
         compute_ms=1e3 * row.compute_s, memory_ms=1e3 * row.memory_s,
         measured_ms_per_step=step_ms, measured_by=("path10_lm_train" if "blocked_ms" in _PATH10
                                                    else "path12_mesh"),
         roofline_over_measured=roof_ms / step_ms,
         note="the memory term counts every eager op's operands and results (unfused)")
    rec, row = recs["path6_prefill/flash"]
    b, s = rec["cut"]["global_batch"], rec["cut"]["seq_len"]
    warm = measure_prefill(torch, b, s)
    roof_s = max(row.compute_s, row.memory_s)
    emit(phase="mesh_roofline_vs_card", model="yi-6b",
         layers=get_model_config("yi-6b").n_layers, batch=b, seq=s, mode="prefill",
         impl="flash", compute_ms=1e3 * row.compute_s, memory_ms=1e3 * row.memory_s,
         measured_prefill_s=statistics.median(warm), measured_prefill_runs_s=warm,
         path6_serve_prefill_s=_PATH6.get("yi_prefill_s"),
         roofline_over_measured=roof_s / statistics.median(warm),
         kernel_calls=rec["hlo"]["kernel_calls"],
         note="the attention core is the kernel op, its work by kernels/work.py's "
              "formula and its q, k, v and output bytes; the rest counts every eager "
              "op's operands and results (unfused); measured: path 6's prefill call "
              "after one warm-up (path6_serve_prefill_s: serve()'s own first call, "
              "when path 6 ran)")
    return {name: rec["seconds"] for name, (rec, _) in recs.items()}


def measure_prefill(torch, batch, prompt, reps=3):
    """Path 6's Yi-6B prefill (full depth, bf16, weights from a seed, the
    kernels) as ``serve`` calls it: the seconds of each of ``reps`` calls
    after one warm-up."""
    from repro_torch.configs import get_model_config
    from repro_torch.models import transformer as T

    cfg = get_model_config("yi-6b")
    params = T.init_params(0, cfg, "cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g, device="cuda")
    out = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = T.prefill(params, cfg, tokens, max_len=prompt + 32, impl="flash",
                              last_only=True)
        torch.cuda.synchronize()
        if i:
            out.append(time.perf_counter() - t0)
        require(bool(torch.isfinite(logits).all()), "path 6 prefill: logits not finite")
        del logits
    del params
    torch.cuda.empty_cache()
    return out


def measure_path10_step(torch, steps=5):
    """Path 10's Yi-6B step (``impl="blocked"``): the median ms of steps 2..n."""
    import dataclasses

    from repro_torch.configs import get_model_config
    from repro_torch.models import transformer as T

    c = LM_TRAIN
    cfg = dataclasses.replace(get_model_config(c["arch"]), n_layers=c["layers"])
    params = T.init_params(0, cfg, "cuda")
    r = run_train(torch, cfg, params, "blocked", steps, c["lr"], c["batch"], c["seq"])
    del params
    torch.cuda.empty_cache()
    return statistics.median(r["ms"][1:])


def phase_mesh(torch, data):
    """Path 12: the dry-runs start first, in processes of their own, and
    run while this process drives the 1x1 mesh on the card."""
    from repro_torch.launch.mesh import destroy_process_group, ensure_process_group, make_host_mesh

    procs = timed("dryrun_start", start_dryruns)
    ensure_process_group("cuda")                  # one-rank NCCL group
    try:
        mesh = make_host_mesh("cuda")
        counts, runs = timed("models", phase_mesh_models, torch, mesh)
        timed("train", phase_mesh_train, torch, mesh)
        timed("fl", phase_mesh_fl, torch, mesh, data)
    finally:
        destroy_process_group()
    dry_s = timed("dryruns", phase_mesh_dryruns, torch, procs)
    totals = {}
    for n in counts.values():
        for k, v in n.items():
            totals[k] = totals.get(k, 0) + v
    emit(phase="main_launches", path="mesh", launches=totals, per_model=counts,
         dryrun_seconds=dry_s)
    return totals, counts


def kernel_entry(name, source, replaces, launches, max_err, row, shape):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row.get("library_ms"),
            "shape": shape}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    only = sys.argv[1:]
    unknown = sorted(set(only) - set(STEPS))
    if unknown:
        raise SystemExit(f"chip_smoke: unknown steps {unknown}; the steps are {list(STEPS)}")
    sys.path.insert(0, str(ROOT / "src"))
    card = card_line()
    try:
        kernels = run_phases(torch, card, only)
    except BaseException as e:
        print(summary_line(False, e), flush=True)
        raise
    print(summary_line(True), flush=True)
    if only:
        print(card, flush=True)
        return 0
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def ptxas_lines(log):
    """Registers, shared memory and spills, each under its kernel's name."""
    out = []
    for ln in log.splitlines():
        if "Function properties for" in ln:
            out.append(ln.split("Function properties for")[-1].strip())
        elif "Used" in ln or "spill" in ln:
            out.append(ln.strip())
    return out


def spill_bytes(log):
    """Every spill-store and spill-load byte count ``ptxas -v`` printed."""
    return [int(v) for pair in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                          log) for v in pair]


STEPS = ("build", "select_topk", "pairwise_rank", "fleet_state", "flash_attention",
         "mamba_rwkv6", "sgd_update", "cpu_vs_card", "full_width", "path1_sync", "path2_il",
         "path3_baselines", "path4_trace", "path5_async", "vmapped",
         "path8_hierarchy", "path6_lm", "path7_ssm", "path9_lm_fl", "obs",
         "path10_lm_train", "path11_zoo", "path12_mesh")


def run_phases(torch, card, only=()):
    """Every step, or only those named in ``only`` (and the build); returns
    the kernels line's entries after a whole run, None after a part."""
    from repro_torch.kernels.flash_attention import kernel as flash_attention_kernel
    from repro_torch.kernels.fleet_state import kernel as fleet_state_kernel
    from repro_torch.kernels.mamba import kernel as mamba_kernel
    from repro_torch.kernels.pairwise_rank import kernel as pairwise_rank_kernel
    from repro_torch.kernels.rwkv6 import kernel as rwkv6_kernel
    from repro_torch.kernels.select_topk import kernel as select_topk_kernel
    from repro_torch.kernels.sgd_update import kernel as sgd_update_kernel

    def want(name):
        return not only or name in only

    # ---- 1: device and build -------------------------------------------
    with step("build"):
        emit(phase="device", name=torch.cuda.get_device_name(0),
             count=torch.cuda.device_count(), torch=torch.__version__,
             cuda=torch.version.cuda, nvidia_smi=card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        libraries = [select_topk_kernel.LIBRARY, pairwise_rank_kernel.LIBRARY,
                     fleet_state_kernel.LIBRARY, flash_attention_kernel.LIBRARY,
                     mamba_kernel.LIBRARY, rwkv6_kernel.LIBRARY, sgd_update_kernel.LIBRARY]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libraries)) as pool:   # one nvcc each, together
            built = list(pool.map(lambda lib: lib.build(), libraries))
        seconds = time.perf_counter() - t0
        for lib, path in zip(libraries, built):
            emit(phase="build", kernel=lib.name, seconds=seconds,
                 library=str(path.relative_to(ROOT)), ptxas=ptxas_lines(lib.build_log))
        for lib in (mamba_kernel.LIBRARY, rwkv6_kernel.LIBRARY, select_topk_kernel.LIBRARY,
                    sgd_update_kernel.LIBRARY):
            spills = spill_bytes(lib.build_log)
            require(lib.build_log == "" or not any(spills),
                    f"{lib.name}: ptxas reports spills {spills}")
        # select_topk's configurations at the timed shapes (path, grid, route)
        topk_configs = [dict(shape=label, n=n, f=f, h=h, k=k,
                             **select_topk_kernel.launch_config(n, f, h, k))
                        for label, n, f, h, k in TOPK_SHAPES]
        emit(phase="launch_config", kernel="select_topk", configs=topk_configs)
        require(all(c["local_bytes"] == 0 and c["resident_per_sm"] >= 1
                    for c in topk_configs), "select_topk: spills or no resident CTA")
        # every instantiation: rwkv6's (n, B * H) routes, mamba's lane splits
        emit(phase="launch_config", kernel="rwkv6",
             configs=[dict(n=n, heads=bh, **rwkv6_kernel.launch_config(n, bh))
                      for n, bh in ((16, 160), (32, 160), (64, 40), (64, 160))])
        emit(phase="launch_config", kernel="mamba",
             configs=[dict(state=st, batch=b, inner=1600,
                           **mamba_kernel.launch_config(st, b, 1600))
                      for st, b in ((4, 4), (8, 4), (16, 1), (16, 4), (32, 4), (64, 4))])
        sgd_configs = [dict(dtype=dt, broadcast=b,
                            **sgd_update_kernel.launch_config(getattr(torch, dt), b))
                       for dt in ("bfloat16", "float32", "float16") for b in (True, False)]
        emit(phase="launch_config", kernel="sgd_update", configs=sgd_configs)
        require(all(c["local_bytes"] == 0 and c["ctas_per_sm"] >= 1 for c in sgd_configs),
                "sgd_update: local memory or no resident CTA")

    # ---- 2-3: kernels against their plain versions, timings -----------
    if want("select_topk"):
        with step("select_topk"):
            max_err = timed("vs_plain", phase_kernel_vs_plain, torch)
            timings = timed("timings", phase_timings, torch, card)
            topk_host = timed("op_host", phase_topk_host, torch, card)
    if want("pairwise_rank"):
        with step("pairwise_rank"):
            pr_errs = timed("vs_plain", phase_pairwise_vs_plain, torch)
            pr_timings = timed("timings", phase_pairwise_timings, torch, card)
    if want("fleet_state"):
        with step("fleet_state"):
            t0 = time.perf_counter()
            big = timed("large_trace", large_trace)
            emit(phase="large_trace", devices=big.n_devices, segments=big.n_segments,
                 seconds=time.perf_counter() - t0)
            fs_err = timed("vs_plain", phase_fleet_state_vs_plain, torch, big)
            fs_timings = timed("timings", phase_fleet_state_timings, torch, card, big)
            fs_host = timed("op_host", phase_fleet_state_host, torch, card)
    if want("flash_attention"):
        with step("flash_attention"):
            fa_err = timed("vs_plain", phase_flash_vs_plain, torch)
            fa_timings = timed("timings", phase_flash_timings, torch, card)
            fa_op = timed("op_route", phase_flash_op_route, torch, card)
    if want("mamba_rwkv6"):
        with step("mamba_rwkv6"):
            scan_err = timed("mamba_vs_plain", phase_scan_vs_plain, torch)
            wkv_err = timed("rwkv6_vs_plain", phase_wkv_vs_plain, torch)
            ssm_timings = timed("timings", phase_ssm_timings, torch, card)
            ssm_op = timed("op_route", phase_ssm_op_route, torch, card)
    if want("sgd_update"):
        with step("sgd_update"):
            sgd_err = timed("vs_plain", phase_sgd_update_vs_plain, torch)
            sgd_timings = timed("timings", phase_sgd_update_timings, torch, card)

    # ---- 4: the CPU and the card agree ----------------------------------
    if want("cpu_vs_card"):
        with step("cpu_vs_card"):
            timed("topk", phase_cpu_agreement, torch)
            timed("policies", phase_cpu_agreement_policies, torch, small_data(4000, 50))
            timed("il", phase_cpu_agreement_il, torch)
            timed("async", phase_cpu_agreement_async, torch)
            timed("hierarchy", phase_cpu_agreement_hierarchy, torch)
            timed("lm", phase_cpu_agreement_lm, torch)
            timed("lm_fl", phase_cpu_agreement_lm_fl, torch)
            timed("lm_train", phase_cpu_agreement_lm_train, torch)
    if want("full_width"):
        with step("full_width"):
            phase_full_width_agreement(torch)

    # ---- 5-13: the paths, each with its own launch counts --------------
    if any(want(name) for name in STEPS if name.startswith("path")
           and name not in ("path10_lm_train", "path11_zoo") or name in ("vmapped", "obs")):
        t0 = time.perf_counter()
        data = small_data(64_000, 1000)
        emit(phase="main_data", samples=64_000, clients=1000,
             seconds=time.perf_counter() - t0)
    if want("path1_sync"):
        with step("path1_sync"):
            sync_counts, srv, policy = timed("rounds", phase_main_path, torch, data)
            timed("profile", phase_profile, torch, srv, policy)
    if want("path2_il"):
        with step("path2_il"):
            il_counts, demos, q = timed("pipeline", phase_il_path, torch, data)
            timed("profile", phase_il_profile, torch, demos, q)
    if want("path3_baselines"):
        with step("path3_baselines"):
            phase_baselines(torch, data)
    if want("path4_trace"):
        with step("path4_trace"):
            trace_counts = phase_trace_path(torch, data)
    if want("path5_async"):
        with step("path5_async"):
            async_runs, (async_srv, async_policy) = timed("runs", phase_async_path,
                                                          torch, data)
            timed("profile", phase_async_profile, torch, async_srv, async_policy)
            timed("oracle", phase_async_oracle, torch, data)
    if want("vmapped"):
        with step("vmapped"):
            phase_vmapped(torch, data)
    if want("path8_hierarchy"):
        with step("path8_hierarchy"):
            hier_counts, hier_runs = phase_hierarchy_path(torch, data)
    if want("path6_lm"):
        with step("path6_lm"):
            lm_counts, lm_runs = timed("serving", phase_serving_path, torch)
            timed("profile", phase_serve_profile, torch)
    if want("path7_ssm"):
        with step("path7_ssm"):
            ssm_counts, ssm_runs = timed("serving", phase_ssm_serving_path, torch)
            timed("serve_profile", phase_ssm_serve_profile, torch)
            timed("decode_profile", phase_ssm_decode_profile, torch)
    if want("path9_lm_fl"):
        with step("path9_lm_fl"):
            lm_fl_counts, _ = timed("yi", phase_lm_fl_path, torch)
            lm_fl_moe_counts = timed("olmoe", phase_lm_fl_moe, torch)
            timed("remat", phase_lm_fl_remat, torch)
    if want("obs"):
        with step("obs"):
            phase_obs(torch, data)
    if want("path10_lm_train"):
        with step("path10_lm_train"):
            lm_train_counts = phase_lm_train_path(torch)
    if want("path11_zoo"):
        with step("path11_zoo"):
            timed("cpu_vs_card", phase_cpu_agreement_zoo, torch)
            zoo_counts, zoo_runs = timed("serving", phase_zoo_serving, torch)
            timed("train", phase_zoo_train, torch)
    if want("path12_mesh"):
        with step("path12_mesh"):
            mesh_counts, mesh_runs = phase_mesh(torch, data)
    if only:
        return None

    # ---- 12: kernels line ----------------------------------------------
    main_shape = timings["main_probe_set"]
    il = pr_timings["il_b16_n30"]
    fs_main = fs_timings["main_week"]
    fa_main = fa_timings["yi_prefill"]
    entries = [
        dict(kernel_entry("select_topk", "src/repro_torch/csrc/select_topk.cu",
                          "src/repro/kernels/select_topk/kernel.py:98",
                          sync_counts["select_topk"], max_err, main_shape,
                          {k: main_shape[k] for k in ("n", "f", "h", "k")}),
             design="register-tiled fp32 scoring; a carried top-K per CTA "
                    "behind a before(row, kth) filter, merged by the last CTA "
                    "(one launch) for K_pad <= 256, a merge tree above",
             library_note="none: no one PyTorch call scores with the MLP and cuts "
                          "a lowest-index-tie top-K",
             op_host_included_ms=topk_host["main_probe_set"]["op_ms"],
             old_sequence_ms=topk_host["main_probe_set"]["old_sequence_ms"],
             op_host_included_ms_n25=topk_host["main_select"]["op_ms"],
             device_kernels_per_op_call={k: r["device_kernels_per_op_call"]
                                         for k, r in topk_host.items()},
             launches_by_path={"path8_hierarchy": hier_counts["select_topk"],
                               "path9_lm_fl": lm_fl_counts["select_topk"],
                               "path9_lm_fl_moe": lm_fl_moe_counts["select_topk"],
                               **{f"path8:{k}": r["select_topk_launches_per_round"]
                                  for k, r in hier_runs.items()
                                  if "select_topk_launches_per_round" in r}},
             ms_by_shape={k: r["ms"] for k, r in timings.items()}),
        dict(kernel_entry("pairwise_rank", "src/repro_torch/csrc/pairwise_rank.cu",
                          "src/repro/kernels/pairwise_rank/kernel.py:61",
                          il_counts["pairwise_rank_fused"],
                          max(pr_errs["fused_loss"], pr_errs["fused_grad"]), il["fused"],
                          {"b": 16, "n": 30, "hard": True}),
             design="fused loss and gradient, one launch a training step",
             library_note="none: no single PyTorch call forms the pair matrices "
                          "and reduces them",
             max_abs_err_by_route=pr_errs,
             loss_only_route={key: il["fwd"][key] for key in
                              ("ms", "plain_ms", "bound_ms", "bound_by")},
             launches_loss_only_route=il_counts["pairwise_rank_fwd"]),
        dict(kernel_entry("fleet_state", "src/repro_torch/csrc/fleet_state.cu",
                          "src/repro/kernels/fleet_state/kernel.py:52",
                          sum(r["launches"]["fleet_state"] for key, r in async_runs.items()
                              if "trace" in key),
                          fs_err, fs_main, {"n": 1000, "s": fs_main["s"]}),
             op_host_included_ms=fs_host["op_ms"],
             numpy_searchsorted_ms=fs_host["numpy_searchsorted_ms"],
             kernel_vs_library={k: r["kernel_vs_library"] for k, r in fs_timings.items()},
             launches_by_path={"trace_sync": trace_counts["fleet_state"],
                               **{f"async:{k}": r["launches"]["fleet_state"]
                                  for k, r in async_runs.items()}}),
        dict(kernel_entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
                          "src/repro/kernels/flash_attention/kernel.py:93",
                          lm_counts["flash_attention"], fa_err[f"bfloat16/{fa_main['route']}"],
                          fa_main, {k: fa_main[k]
                                    for k in ("b", "s", "h", "kv", "dh", "window", "dtype")}),
             main_shape_route=fa_main["route"], max_abs_err_by_route=fa_err,
             launches_by_run=lm_runs, launches_ssm_serving=ssm_counts["flash_attention"],
             launches_zoo_serving=zoo_counts["flash_attention"],
             launches_by_zoo_run=zoo_runs, op_route=fa_op["yi_prefill"],
             zoo_shapes={k: {f: fa_timings[k][f] for f in
                             ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "causal")}
                         for k in ("whisper_encoder", "olmoe_prefill")}),
        dict(kernel_entry("mamba", "src/repro_torch/csrc/mamba.cu",
                          "src/repro/kernels/mamba/kernel.py:68",
                          ssm_counts["mamba"], scan_err, ssm_timings["hymba_prefill"],
                          {k: ssm_timings["hymba_prefill"][k]
                           for k in ("b", "t", "inner", "state")}),
             library_note=SSM_NO_LIBRARY, launches_by_run=ssm_runs,
             op_route=ssm_op["hymba_decode"],
             ms_back_to_back=ssm_timings["hymba_prefill"]["ms_back_to_back"],
             launch_config=ssm_timings["hymba_prefill"]["launch"]),
        dict(kernel_entry("rwkv6", "src/repro_torch/csrc/rwkv6.cu",
                          "src/repro/kernels/rwkv6/kernel.py:74",
                          ssm_counts["rwkv6"], wkv_err, ssm_timings["rwkv6_prefill"],
                          {k: ssm_timings["rwkv6_prefill"][k] for k in ("b", "t", "h", "n")}),
             library_note=SSM_NO_LIBRARY, launches_by_run=ssm_runs,
             op_route=ssm_op["rwkv6_decode"],
             ms_back_to_back=ssm_timings["rwkv6_prefill"]["ms_back_to_back"],
             launch_config=ssm_timings["rwkv6_prefill"]["launch"]),
        dict(kernel_entry("sgd_update", "src/repro_torch/csrc/sgd_update.cu",
                          "none: the reference's client step, fused by XLA inside its "
                          "lax.scan (src/repro/fl/client.py:157-159)",
                          lm_fl_counts["sgd_update"], sgd_err, sgd_timings["yi_embed_stacked"],
                          {k: sgd_timings["yi_embed_stacked"][k]
                           for k in ("k", "shape", "dtype", "broadcast")}),
             library_note="torch.add(a, g, alpha=-lr): one call, timed only",
             ms_by_shape={k: r["ms"] for k, r in sgd_timings.items()},
             share_of_peak_by_shape={k: r["share_of_peak"] for k, r in sgd_timings.items()},
             launches_by_path={"path1_sync": sync_counts["sgd_update"],
                               "path9_lm_fl_moe": lm_fl_moe_counts["sgd_update"]},
             launch_config=sgd_timings["yi_embed_stacked"]["launch"]),
    ]
    # the DTensor route on the 1x1 mesh (path 12): the same kernels on the
    # local shards
    for e in entries:
        if e["name"] in mesh_counts:
            e["launches_dtensor_route"] = mesh_counts[e["name"]]
            e["launches_dtensor_route_by_model"] = {
                arch: n[e["name"]] for arch, n in mesh_runs.items() if n[e["name"]]}
    # LM training (path 10) runs none of the kernels: no backward exists
    for e in entries:
        e["launches_lm_train"] = sum(n for k, n in lm_train_counts.items()
                                     if k.startswith(e["name"]) and k != "flash_attention_mma")
    return entries


if __name__ == "__main__":
    sys.exit(main())
