"""Offline pre-training with imitation learning (paper Alg. 1).

Behavioral cloning against the analytical experts: run each expert policy in
the FL simulator, record the visited cohort states and the expert's utility
scores, then train the Q-net so its ranking matches the expert's via the
pairwise loss (L_theta(s, pi*) = RankNet BCE against the expert ordering).

Using MULTIPLE diverse experts (oort + harmony + fedmarl) is the paper's
Fig. 4 finding — the demonstrations are pooled.

Demonstrations are host numpy, drawn from the same numpy streams as the
reference.  Training runs on the Q-net's device: the padded demonstration
tensors are uploaded once, every step's batch is one (B, max_m) call of the
loss, so on the card a step launches the ``pairwise_rank`` forward and
gradient kernels once each.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core import experts as experts_lib
from repro_torch.core.baselines import ExpertPolicy
from repro_torch.core.features import get_feature_set
from repro_torch.core.qnet import apply_qnet, init_qnet
from repro_torch.core.ranking import pairwise_bce_hard, ranking_accuracy, topk_overlap
from repro_torch.kernels.select_topk.ops import select_topk

OBJECTIVES = ("pairwise", "pointwise", "pointwise_raw")


@dataclass
class Demonstration:
    states: np.ndarray          # (M, state_dim) raw probe states — width
    #                             follows the recording env's feature set
    scores: np.ndarray          # (M,) expert utility
    expert: str


class _RecordingExpert(ExpertPolicy):
    """ExpertPolicy that records (states, scores) demonstrations."""

    def __init__(self, expert_name: str, store: List[Demonstration], l_ep: int = 5):
        super().__init__(expert_name, l_ep=l_ep)
        self.store = store

    def select(self, ctx, probe_ids, probe_states):
        util = experts_lib.expert_scores(self.expert_name, probe_states,
                                         l_ep=self.l_ep)
        self.store.append(Demonstration(probe_states.copy(), util.copy(),
                                        self.expert_name))
        idx, _ = select_topk(None, util, None, ctx.k)
        return probe_ids[idx]


def collect_demonstrations(
    make_server: Callable[[], "object"],
    expert_names: Sequence[str] = ("oort", "harmony", "fedmarl"),
    rounds_per_expert: int = 15,
) -> List[Demonstration]:
    """Run each expert in a fresh FL environment, recording visited states
    (Alg. 1 lines 3-5)."""
    demos: List[Demonstration] = []
    for name in expert_names:
        server = make_server()
        policy = _RecordingExpert(name, demos)
        server.run(policy, rounds=rounds_per_expert)
    return demos


def augment_demonstrations(demos: List[Demonstration], n_synthetic: int = 200,
                           cohort: int = 30, seed: int = 0,
                           expert_names: Sequence[str] = ("oort", "harmony", "fedmarl"),
                           feature_set: str = "paper6",
                           ) -> List[Demonstration]:
    """Cheap expert queries on synthetic states — IL's "probe the expert
    anywhere" advantage (§2.2): broadens coverage beyond visited states.
    ``feature_set`` shapes the synthetic states (experts only score the
    paper block; wider sets draw a plausible history block so the cloned
    Q-net sees full-width inputs)."""
    fs = get_feature_set(feature_set)
    rng = np.random.default_rng(seed)
    out = list(demos)
    for _ in range(n_synthetic):
        states = fs.synthetic_states(rng, cohort)
        name = expert_names[int(rng.integers(len(expert_names)))]
        scores = experts_lib.expert_scores(name, states, l_ep=5)
        out.append(Demonstration(states, scores, name))
    return out


def pretrain_qnet(
    demos: List[Demonstration],
    *,
    seed: int = 0,
    steps: int = 2000,
    batch: int = 16,
    lr: float = 1e-3,
    qnet_params=None,
    objective: str = "pairwise",   # "pairwise" (paper) | "pointwise" ablations
    feature_set: str = "paper6",   # featurization of the recorded states —
    #                                must match the env that recorded them
    device: DeviceLike = None,
) -> Tuple[Dict[str, torch.Tensor], Dict[str, list]]:
    """Behavioral cloning. ``objective="pairwise"`` is the paper's RankNet
    BCE over expert orderings; ``"pointwise"`` regresses the z-scored expert
    utility with MSE and ``"pointwise_raw"`` the globally scaled raw utility
    (the Fig. 5d ablation axis).

    A fresh Q-net comes from ``init_qnet(seed, in_dim=fs.feature_dim,
    device=device)`` (the card unless ``device="cpu"``); given
    ``qnet_params`` are copied, onto ``device`` when one is named.  The
    returned Q-net's input width follows ``feature_set`` (pass the same
    name to ``build_policy("fedrank", ...)``).  ``hist`` records the loss,
    ranking accuracy and top-10 overlap every 100 steps and at the last."""
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; expected one of "
                         f"{OBJECTIVES}")
    fs = get_feature_set(feature_set)
    if qnet_params is not None:
        dev = (resolve_device(device) if device is not None
               else qnet_params["w1"].device)
        q = {n: t.detach().to(dev).clone() for n, t in qnet_params.items()}
    else:
        q = init_qnet(seed, in_dim=fs.feature_dim, device=device)
        dev = q["w1"].device
    rng = np.random.default_rng(seed + 1)

    bad = {d.states.shape[1] for d in demos} - {fs.state_dim}
    if bad:
        raise ValueError(
            f"demonstration state widths {sorted(bad)} do not match feature "
            f"set {fs.name!r} (state_dim={fs.state_dim}) — record and "
            "pretrain with the same feature_set")
    # pre-featurize cohorts, pad to common M
    max_m = max(len(d.states) for d in demos)
    feats = np.zeros((len(demos), max_m, fs.feature_dim), np.float32)
    tgts = np.zeros((len(demos), max_m), np.float32)
    raw_tgts = np.zeros((len(demos), max_m), np.float32)
    masks = np.zeros((len(demos), max_m), np.float32)
    all_scores = np.concatenate([d.scores for d in demos])
    raw_scale = float(np.abs(all_scores).mean()) + 1e-9
    for i, d in enumerate(demos):
        m = len(d.states)
        feats[i, :m] = fs.featurize(d.states)
        s = d.scores
        tgts[i, :m] = (s - s.mean()) / (s.std() + 1e-9)
        # raw "absolute artificial score" (global scale only — what the
        # paper's pointwise baselines regress)
        raw_tgts[i, :m] = s / raw_scale
        masks[i, :m] = 1.0
    train_np = raw_tgts if objective == "pointwise_raw" else tgts

    as_dev = lambda a: torch.as_tensor(a, device=dev)
    feats_t, tgts_t, masks_t = as_dev(feats), as_dev(tgts), as_dev(masks)
    train_t = as_dev(train_np)
    # every step's batch, drawn up front from the reference's stream (the
    # generator serves nothing else), so the loop never waits on the host
    draws = np.stack([rng.choice(len(demos), size=min(batch, len(demos)),
                                 replace=False) for _ in range(steps)]
                     ) if steps else np.zeros((0, 0), np.int64)
    draws_t = as_dev(draws)

    def loss_fn(q, f, t, m):
        scores = apply_qnet(q, f)                       # (B, max_m)
        if objective.startswith("pointwise"):
            per = (torch.square(scores - t) * m).sum(-1) / torch.clamp(
                m.sum(-1), min=1.0)
        else:
            per = pairwise_bce_hard(scores, t, m)
        return per.mean()

    @torch.no_grad()
    def eval_metrics(q):
        scores = apply_qnet(q, feats_t)
        return (ranking_accuracy(scores, tgts_t, masks_t).mean(),
                topk_overlap(scores, tgts_t, 10, masks_t).mean())

    names = list(q)
    opt_m = {n: torch.zeros_like(q[n]) for n in names}
    opt_v = {n: torch.zeros_like(q[n]) for n in names}
    hist: Dict[str, list] = {"loss": [], "rank_acc": [], "top10_overlap": []}
    b1, b2, eps = 0.9, 0.999, 1e-8
    for step in range(steps):
        idx = draws_t[step]
        leaves = [q[n].detach().requires_grad_(True) for n in names]
        loss = loss_fn(dict(zip(names, leaves)), feats_t[idx], train_t[idx],
                       masks_t[idx])
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        t = step + 1
        with torch.no_grad():
            opt_m = {n: b1 * opt_m[n] + (1 - b1) * grads[n] for n in names}
            opt_v = {n: b2 * opt_v[n] + (1 - b2) * grads[n] * grads[n]
                     for n in names}
            q = {n: leaf.detach() - lr * (opt_m[n] / (1 - b1 ** t))
                 / (torch.sqrt(opt_v[n] / (1 - b2 ** t)) + eps)
                 for n, leaf in zip(names, leaves)}
        if step % 100 == 0 or step == steps - 1:
            ra, tk = eval_metrics(q)
            l, ra, tk = torch.stack([loss.detach(), ra, tk]).tolist()
            hist["loss"].append(l)
            hist["rank_acc"].append(ra)
            hist["top10_overlap"].append(tk)
    return q, hist
