"""Online double-Q learning for FedRank (paper §3.3 + §3.4).

The "Profiler Cache" replay buffer stores per-round transitions
<s_t, a_t, r_t, s_{t+1}> over the probed cohort; the TD loss uses the VDN
sum of selected devices' Q-values (Eq. 2) with a periodically-copied target
network, and the joint objective adds the pairwise RankNet term (Eq. 5):

    L = L_RL + eps * L_Rank

The train step is torch autograd over the whole batch of transitions, with
the reference's inline Adam.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.qnet import apply_qnet
from repro_torch.core.ranking import pairwise_bce, pairwise_soft_targets
from repro_torch.kernels.select_topk.ops import masked_topk

MAX_COHORT = 64

Params = Dict[str, torch.Tensor]
Batch = Tuple[torch.Tensor, ...]


@dataclass
class Transition:
    feats: np.ndarray        # (MAX_COHORT, F)
    mask: np.ndarray         # (MAX_COHORT,)
    action: np.ndarray       # (MAX_COHORT,) 0/1
    reward: float
    next_feats: np.ndarray   # (MAX_COHORT, F)
    next_mask: np.ndarray    # (MAX_COHORT,)
    k: int


def pad_cohort(feats: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a (M, F) cohort to (MAX_COHORT, F) + validity mask."""
    m = len(feats)
    if m > MAX_COHORT:
        raise ValueError(f"cohort {m} exceeds MAX_COHORT {MAX_COHORT}")
    out = np.zeros((MAX_COHORT, feats.shape[1]), np.float32)
    out[:m] = feats
    mask = np.zeros((MAX_COHORT,), np.float32)
    mask[:m] = 1.0
    return out, mask


class ReplayBuffer:
    """The Profiler Cache (same numpy RNG stream as the reference)."""

    def __init__(self, capacity: int = 512, seed: int = 0):
        self.capacity = capacity
        self.items: List[Transition] = []
        self.rng = np.random.default_rng(seed)

    def add(self, tr: Transition) -> None:
        if len(self.items) >= self.capacity:
            self.items.pop(0)
        self.items.append(tr)

    def sample(self, n: int) -> List[Transition]:
        n = min(n, len(self.items))
        # with-replacement sampling while the buffer is small keeps early
        # online training active (the paper trains from round ~1)
        replace = len(self.items) < n * 2
        idx = self.rng.choice(len(self.items), size=n, replace=replace)
        return [self.items[i] for i in idx]

    def __len__(self) -> int:
        return len(self.items)


def batch_transitions(trs: List[Transition], device: torch.device) -> Batch:
    """Stack transitions into (feats, mask, action, reward, next_feats,
    next_mask) tensors on ``device``."""
    as_t = lambda a: torch.as_tensor(a, device=device)
    return (
        as_t(np.stack([t.feats for t in trs])),
        as_t(np.stack([t.mask for t in trs])),
        as_t(np.stack([t.action for t in trs])),
        as_t(np.array([t.reward for t in trs], np.float32)),
        as_t(np.stack([t.next_feats for t in trs])),
        as_t(np.stack([t.next_mask for t in trs])),
    )


def td_loss(q: Params, q_target: Params, batch: Batch, *, gamma: float,
            rank_eps: float, k: int):
    """Joint loss over a batch: feats (B,M,F), mask (B,M), action (B,M),
    reward (B,), next_feats (B,M,F), next_mask (B,M).  Returns (loss,
    {"l_rl", "l_rank"})."""
    feats, mask, action, reward, nfeats, nmask = batch
    qs = apply_qnet(q, feats)                          # (B, M)
    pred = (qs * action).sum(-1)                       # VDN over selected
    with torch.no_grad():
        # double-Q bootstrap: the online net picks the top-k, the target net
        # evaluates — same masking + lowest-index tie rule as selection
        _, top = masked_topk(apply_qnet(q, nfeats), nmask, k)
        boot = apply_qnet(q_target, nfeats).gather(-1, top).sum(-1)
        target = reward + gamma * boot
        # pairwise rank term against target-net pair probabilities (Eq. 3)
        soft = pairwise_soft_targets(apply_qnet(q_target, feats))
    l_rl = torch.square(pred - target)
    l_rank = pairwise_bce(qs, soft, mask)
    loss = (l_rl + rank_eps * l_rank).mean()
    return loss, {"l_rl": l_rl.mean(), "l_rank": l_rank.mean()}


def make_td_train_step(gamma: float, rank_eps: float, k: int, lr: float):
    """Builds the joint-loss gradient step:
    ``step(q, q_target, opt_m, opt_v, t, batch) -> (q, opt_m, opt_v, t,
    loss, aux)`` with the reference's inline Adam."""

    def step(q, q_target, opt_m, opt_v, t, batch):
        names = list(q)
        leaves = [q[n].detach().requires_grad_(True) for n in names]
        loss, aux = td_loss(dict(zip(names, leaves)), q_target, batch,
                            gamma=gamma, rank_eps=rank_eps, k=k)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        b1, b2, eps = 0.9, 0.999, 1e-8
        t = t + 1
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        with torch.no_grad():
            opt_m = {n: b1 * opt_m[n] + (1 - b1) * grads[n] for n in names}
            opt_v = {n: b2 * opt_v[n] + (1 - b2) * grads[n] * grads[n]
                     for n in names}
            q = {n: leaf.detach() - lr * (opt_m[n] / bc1)
                 / (torch.sqrt(opt_v[n] / bc2) + eps)
                 for n, leaf in zip(names, leaves)}
        return q, opt_m, opt_v, t, loss.detach(), {
            name: v.detach() for name, v in aux.items()}

    return step
