"""Baseline selection policies (paper §4.1 baselines A/B/C).

A. Random:   FedAvg (uniform random), FedProx (random + proximal local
             objective — the prox term itself is FLConfig.prox_mu).
B. Heuristic: AFL (loss-conditioned sampling), TiFL (latency tiers),
             Oort (utility = statistical x system, Eq. 10).
C. Learning: Favor-like (pointwise double-DQN over bookkeeping states),
             FedMarl-like (probing + its reward terms as a greedy score).

Plus :class:`ExpertPolicy`, the analytical IL teachers as probing policies.
Every policy draws from ``ctx.rng`` in the reference's order, so cohorts
equal the reference's.  Cohort cuts go through
:func:`repro_torch.kernels.select_topk.ops.select_topk`: Favor's fleet cut
is the fused CUDA scoring + top-K kernel on the card, the analytical
utilities are partial-selected on the host.  All policies implement the
``SelectionPolicy`` protocol of :mod:`repro_torch.fl.server`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import DeviceLike
from repro_torch.core import experts
from repro_torch.core.features import featurize
from repro_torch.core.qnet import apply_qnet, hard_update, init_qnet
from repro_torch.fl.server import RoundContext, RoundResult
from repro_torch.kernels.select_topk.ops import select_topk


class _Base:
    needs_probing = False

    def probe_set(self, ctx: RoundContext) -> np.ndarray:
        avail = ctx.available_ids()
        m = min(len(avail), max(ctx.k, int(round(ctx.k * 3.0))))
        return ctx.rng.choice(avail, size=m, replace=False)

    def observe(self, ctx, result, probe_ids, probe_states) -> None:
        pass


class RandomPolicy(_Base):
    """FedAvg / FedProx selection: uniform random K of N (online only)."""

    def __init__(self, name: str = "fedavg"):
        self.name = name

    def select(self, ctx: RoundContext, probe_ids, probe_states) -> np.ndarray:
        avail = ctx.available_ids()
        return ctx.rng.choice(avail, size=min(ctx.k, len(avail)), replace=False)


class AFLPolicy(_Base):
    """Active FL: sample with probability conditioned on each client's
    valuation, with a softmax temperature and an eps floor of uniform
    exploration.

    The valuation is the normalized training loss (classic AFL), plus a
    loss-age exploration bonus ``age_weight * sqrt(age / (1 + round))`` for
    devices whose loss is stale bookkeeping, minus ``stale_weight *
    staleness_ewma`` from the device telemetry (zero until a device has a
    merge history, so the first rounds are classic AFL).
    """

    name = "afl"

    def __init__(self, temperature: float = 0.5, eps: float = 0.2,
                 age_weight: float = 0.5, stale_weight: float = 0.25):
        self.temperature = temperature
        self.eps = eps
        self.age_weight = age_weight
        self.stale_weight = stale_weight

    def _valuation(self, ctx: RoundContext, avail: np.ndarray) -> np.ndarray:
        val = ctx.last_loss[avail] / max(ctx.last_loss[avail].std(), 1e-9)
        if self.age_weight and ctx.loss_age is not None:
            val = val + self.age_weight * np.sqrt(
                np.maximum(ctx.loss_age[avail], 0.0) / (1.0 + ctx.round))
        if self.stale_weight and ctx.telemetry is not None:
            val = val - self.stale_weight * ctx.telemetry.staleness_ewma[avail]
        return val

    def select(self, ctx: RoundContext, probe_ids, probe_states) -> np.ndarray:
        avail = ctx.available_ids()
        val = self._valuation(ctx, avail)
        p = np.exp((val - val.max()) / self.temperature)
        p = (1 - self.eps) * p / p.sum() + self.eps / len(avail)
        p /= p.sum()
        return ctx.rng.choice(avail, size=min(ctx.k, len(avail)),
                              replace=False, p=p)


class TiFLPolicy(_Base):
    """Tier-based FL: devices bucketed into latency tiers; each round one
    tier is chosen (credit-decayed adaptive schedule) and K devices are
    sampled within it — bounding intra-round straggling."""

    name = "tifl"

    def __init__(self, n_tiers: int = 5):
        self.n_tiers = n_tiers
        self.credits: Optional[np.ndarray] = None
        self.tier_of: Optional[np.ndarray] = None
        self.tier_gain = None
        self._last_tier = 0

    def _build(self, ctx: RoundContext):
        # stable sort: latency ties land in the same tier on every platform
        order = np.argsort(ctx.est_t_round, kind="stable")
        self.tier_of = np.zeros(ctx.n, int)
        for t, chunk in enumerate(np.array_split(order, self.n_tiers)):
            self.tier_of[chunk] = t
        self.credits = np.full(self.n_tiers, float(ctx.round + 100))
        self.tier_gain = np.ones(self.n_tiers)

    def select(self, ctx: RoundContext, probe_ids, probe_states) -> np.ndarray:
        if self.tier_of is None:
            self._build(ctx)
        probs = self.tier_gain * (self.credits > 0)
        if probs.sum() <= 0:
            probs = np.ones(self.n_tiers)
        probs = probs / probs.sum()
        tier = int(ctx.rng.choice(self.n_tiers, p=probs))
        self._last_tier = tier
        avail = ctx.available_ids()
        members = avail[self.tier_of[avail] == tier]
        if len(members) < ctx.k:
            extra = np.setdiff1d(avail, members)
            members = np.concatenate([members, extra])
        self.credits[tier] -= 1
        return ctx.rng.choice(members, size=min(ctx.k, len(members)),
                              replace=False)

    def observe(self, ctx, result: RoundResult, probe_ids, probe_states) -> None:
        gain = max(result.d_acc, 1e-4)
        self.tier_gain[self._last_tier] = (0.7 * self.tier_gain[self._last_tier]
                                           + 0.3 * gain / 1e-2)


class OortPolicy(_Base):
    """Oort: utility-driven selection with epsilon-greedy exploration of
    rarely-observed clients (the paper's exploitation/exploration split)."""

    name = "oort"

    def __init__(self, alpha: float = 2.0, explore_frac: float = 0.2):
        self.alpha = alpha
        self.explore_frac = explore_frac

    def _utilities(self, ctx: RoundContext) -> np.ndarray:
        """(N,) oort utility per device (the telemetry-aware subclass hooks
        in here; selection around it is shared)."""
        states = np.stack([
            ctx.est_t_round / 5.0,                 # est per-epoch compute time
            ctx.sys.t_comm, ctx.sys.e_comp, ctx.sys.e_comm,
            ctx.last_loss, ctx.data_sizes.astype(float)], axis=1)
        util = experts.oort_utility(states, l_ep=5, alpha=self.alpha)
        # oort's over-participation decay + staleness exploration bonus
        util = util / np.sqrt(1.0 + ctx.selection_count)
        util = util * (1.0 + 0.1 * np.sqrt(ctx.loss_age / (1.0 + ctx.round)))
        return util

    def select(self, ctx: RoundContext, probe_ids, probe_states) -> np.ndarray:
        util = self._utilities(ctx)
        avail = ctx.available_ids()
        k = min(ctx.k, len(avail))
        n_explore = int(round(self.explore_frac * k))
        n_exploit = k - n_explore
        exploit_idx, _ = select_topk(None, util, ctx.available, n_exploit)
        chosen = list(exploit_idx)
        rest = np.setdiff1d(avail, chosen)
        n_explore = min(n_explore, len(rest))
        if n_explore > 0:
            chosen += list(ctx.rng.choice(rest, size=n_explore, replace=False))
        return np.asarray(chosen)


class OortTelemetryPolicy(OortPolicy):
    """Oort whose utility reads the device telemetry history the learned
    policies see.  Three multiplicative discounts, each exactly 1 while the
    telemetry holds no observations (so with empty telemetry this is plain
    Oort, same RNG consumption): the EWMA online fraction, the observed
    success probability ``1 - dropout_rate``, and the observed slowdown
    ``(est / obs) ** alpha`` capped at 1."""

    name = "oort-telemetry"

    def _utilities(self, ctx: RoundContext) -> np.ndarray:
        util = super()._utilities(ctx)
        tel = ctx.telemetry
        if tel is None:
            return util
        ids = np.arange(ctx.n)
        util = util * tel.online_frac                 # prior 1.0 => no-op
        util = util * (1.0 - tel.dropout_rate(ids))   # 0/0 counts => 0 rate
        t_obs = tel.expected_completion_s(ids, ctx.est_t_round)
        slowdown = ctx.est_t_round / np.maximum(t_obs, 1e-9)
        return util * np.clip(slowdown, 0.0, 1.0) ** self.alpha


class FavorPolicy(_Base):
    """Favor-like: pointwise double-DQN over bookkeeping states (no probing,
    no ranking loss) — the representative pointwise learning baseline.

    The Q-net lives on ``device`` (the card unless ``device="cpu"``); its TD
    step is torch autograd with plain SGD, the bootstrap's top-k sum stays
    on the host as in the reference."""

    name = "favor"

    def __init__(self, seed: int = 0, lr: float = 1e-3, gamma: float = 0.9,
                 eps: float = 0.3, eps_decay: float = 0.97,
                 device: DeviceLike = None):
        self.q = init_qnet(seed, device=device)
        self.q_target = hard_update(None, self.q)
        self.lr, self.gamma = lr, gamma
        self.eps, self.eps_decay = eps, eps_decay
        self._prev = None  # (feats, action_mask, reward)
        self._steps = 0

    def _bookkeeping_states(self, ctx: RoundContext) -> np.ndarray:
        return np.stack([
            ctx.est_t_round / 5.0, ctx.sys.t_comm, ctx.sys.e_comp,
            ctx.sys.e_comm, ctx.last_loss, ctx.data_sizes.astype(float)], axis=1)

    def select(self, ctx: RoundContext, probe_ids, probe_states) -> np.ndarray:
        feats = featurize(self._bookkeeping_states(ctx))
        avail = ctx.available_ids()
        k = min(ctx.k, len(avail))
        if ctx.rng.random() < self.eps:
            return ctx.rng.choice(avail, size=k, replace=False)
        # fused Q-net scoring + top-K over the fleet, offline devices masked
        idx, _ = select_topk(self.q, feats, ctx.available, k)
        return idx

    def _td_step(self, feats: np.ndarray, act: np.ndarray,
                 target: np.float32) -> None:
        """One SGD step on (sum of the taken actions' Q - target)^2."""
        dev = self.q["w1"].device
        names = list(self.q)
        leaves = [self.q[n].detach().requires_grad_(True) for n in names]
        qs = apply_qnet(dict(zip(names, leaves)), torch.as_tensor(feats, device=dev))
        pred = (qs * torch.as_tensor(act, device=dev)).sum()
        loss = torch.square(pred - torch.as_tensor(target, dtype=torch.float32,
                                                   device=dev))
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            self.q = {n: p.detach() - self.lr * g
                      for n, p, g in zip(names, leaves, grads)}

    def observe(self, ctx, result: RoundResult, probe_ids, probe_states) -> None:
        feats = featurize(self._bookkeeping_states(ctx))
        act = np.zeros(ctx.n, np.float32)
        act[result.selected] = 1.0
        if self._prev is not None:
            pfeats, pact, prew = self._prev
            with torch.no_grad():
                q_next = apply_qnet(self.q_target, torch.as_tensor(
                    feats, device=self.q_target["w1"].device)).cpu().numpy()
            boot = np.sort(q_next)[-ctx.k:].sum()
            target = prew + self.gamma * boot
            self._td_step(pfeats, pact, np.float32(target))
            self._steps += 1
            if self._steps % 10 == 0:
                self.q_target = hard_update(self.q_target, self.q)
        self._prev = (feats, act, result.reward)
        self.eps *= self.eps_decay


class FedMarlPolicy(_Base):
    """FedMarl-like: probing (its H^p term) + greedy score from its reward
    terms (accuracy-gain proxy, latency, comm cost)."""

    name = "fedmarl"
    needs_probing = True

    def select(self, ctx: RoundContext, probe_ids, probe_states) -> np.ndarray:
        idx, _ = select_topk(lambda s: experts.fedmarl_utility(s, l_ep=5),
                             probe_states, None, ctx.k)
        return probe_ids[idx]


class ExpertPolicy(_Base):
    """Wraps any analytical expert scorer as a probing policy (used to
    generate IL demonstrations and as an upper-baseline)."""

    needs_probing = True

    def __init__(self, expert_name: str, l_ep: int = 5):
        self.name = f"expert-{expert_name}"
        self.expert_name = expert_name
        self.l_ep = l_ep

    def select(self, ctx: RoundContext, probe_ids, probe_states) -> np.ndarray:
        idx, _ = select_topk(
            lambda s: experts.expert_scores(self.expert_name, s, l_ep=self.l_ep),
            probe_states, None, ctx.k)
        return probe_ids[idx]
