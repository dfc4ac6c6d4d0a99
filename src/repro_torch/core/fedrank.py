"""FedRank — the paper's selection policy, end to end.

Probing cohort -> cohort-normalized features -> per-device Q-net -> top-K,
with (a) IL-pretrained initialization when ``qnet_params`` is given, (b)
online double-Q TD refinement with the Profiler Cache (Eq. 2), and (c) the
pairwise RankNet term in the joint loss (Eq. 5).  Ablation flags give
FedRank^{-I} (no IL), FedRank^{-P} (no pairwise loss) and FedRank^{-IP}.

Both cohort cuts go through :func:`repro_torch.kernels.select_topk.ops.select_topk`:
on the card that is the fused CUDA scoring + top-K kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.dqn import (
    MAX_COHORT,
    ReplayBuffer,
    Transition,
    batch_transitions,
    make_td_train_step,
    pad_cohort,
)
from repro_torch.core.features import get_feature_set
from repro_torch.core.qnet import hard_update, init_qnet
from repro_torch.fl.server import RoundContext, RoundResult
from repro_torch.kernels.select_topk.ops import select_topk
from repro_torch.obs.profiling import span


class FedRankPolicy:
    needs_probing = True

    def __init__(
        self,
        qnet_params=None,              # IL-pretrained params (None => cold start)
        *,
        feature_set: str = "paper6",   # probe-state feature set; the Q-net
        #                                input width follows it (must match
        #                                FLConfig.feature_set)
        seed: int = 0,
        gamma: float = 0.9,
        rank_eps: float = 0.5,         # epsilon in L = L_RL + eps * L_Rank
        lr: float = 5e-4,
        explore_eps: float = 0.1,
        explore_decay: float = 0.95,
        target_period: int = 5,
        replay_capacity: int = 512,
        train_batch: int = 8,
        train_steps_per_round: int = 4,
        probe_factor: float = 2.5,
        online: bool = True,
        use_rank_loss: bool = True,
        k: int = 10,
        name: str = "fedrank",
        device: DeviceLike = None,     # Q-net device: the card unless "cpu";
        #                                given params keep their own device
    ):
        self.name = name
        self.fs = get_feature_set(feature_set)
        if qnet_params is not None:
            self.q = {n: t.detach().clone() for n, t in qnet_params.items()}
        else:
            self.q = init_qnet(seed, in_dim=self.fs.feature_dim,
                               device=resolve_device(device))
        self.device = self.q["w1"].device
        q_in = int(self.q["w1"].shape[0])
        if q_in != self.fs.feature_dim:
            raise ValueError(
                f"Q-net input width {q_in} does not match feature set "
                f"{self.fs.name!r} (feature_dim={self.fs.feature_dim}) — "
                "pretrain the Q-net on the same feature set it selects with")
        self.q_target = hard_update(None, self.q)
        self.gamma = gamma
        self.rank_eps = rank_eps if use_rank_loss else 0.0
        self.explore_eps = explore_eps
        self.explore_decay = explore_decay
        self.target_period = target_period
        self.train_batch = train_batch
        self.train_steps_per_round = train_steps_per_round
        self.probe_factor = probe_factor
        self.online = online
        self.replay = ReplayBuffer(replay_capacity, seed=seed + 3)
        self._train_step = make_td_train_step(gamma, self.rank_eps, k, lr)
        self._opt_m = {n: torch.zeros_like(t) for n, t in self.q.items()}
        self._opt_v = {n: torch.zeros_like(t) for n, t in self.q.items()}
        self._opt_t = 0
        self._rounds_seen = 0
        self._pending = None          # (feats, mask, action) awaiting next state
        self.metrics: Dict[str, List[float]] = {"loss": [], "l_rl": [], "l_rank": []}

    # ------------------------------------------------------------------
    def probe_set(self, ctx: RoundContext) -> np.ndarray:
        """Provisional candidates to probe (paper §3.1): rank the ONLINE
        devices on *bookkeeping* states (static estimates + last observed
        loss) with the current Q-net, probe the top candidates plus a few
        explorers — the probe then reveals true runtime state for the final
        top-K cut."""
        avail = ctx.available_ids()
        m = min(len(avail), MAX_COHORT,
                max(ctx.k, int(round(ctx.k * self.probe_factor))))
        with span("featurize"):
            book = self.fs.bookkeeping_states(ctx)
            feats = self.fs.featurize(book)
        n_explore = max(1, m // 5)
        # fused score -> top-K over the whole fleet: offline devices are
        # masked and the over-participation decay streams in as the bias
        top_idx, _ = select_topk(
            self.q, feats, ctx.available, m - n_explore,
            bias=-0.05 * np.sqrt(ctx.selection_count))
        top = list(top_idx)
        # exploration probes avoid known stragglers (T_prob = max over the
        # cohort): sample explorers from the faster part of the online pool
        fast = avail[ctx.est_t_round[avail]
                     <= np.percentile(ctx.est_t_round[avail], 60)]
        rest = np.setdiff1d(fast, top)
        if len(rest) == 0:
            rest = np.setdiff1d(avail, top)
        if len(rest) and n_explore:
            top += list(ctx.rng.choice(rest, size=min(n_explore, len(rest)),
                                       replace=False))
        return np.asarray(top)

    def select(self, ctx: RoundContext, probe_ids: np.ndarray,
               probe_states: np.ndarray) -> np.ndarray:
        if probe_states.shape[1] != self.fs.state_dim:
            raise ValueError(
                f"policy {self.name!r} expects {self.fs.name!r} probe states "
                f"(width {self.fs.state_dim}), got width "
                f"{probe_states.shape[1]} — set FLConfig.feature_set to match")
        feats = self.fs.featurize(probe_states)
        # full ordering of the probe cohort (epsilon-greedy swaps pull from
        # the tail, so k = cohort size), fused score+rank in one op
        order, _ = select_topk(self.q, feats, None, len(feats))
        chosen = list(order[:ctx.k])
        # epsilon-greedy: swap a random tail element in occasionally
        if ctx.rng.random() < self.explore_eps and len(order) > ctx.k:
            swap_out = int(ctx.rng.integers(ctx.k))
            swap_in = int(ctx.rng.integers(ctx.k, len(order)))
            chosen[swap_out] = order[swap_in]
        self._last = (feats, probe_ids, np.asarray(chosen))
        return probe_ids[np.asarray(chosen)]

    # ------------------------------------------------------------------
    def observe(self, ctx: RoundContext, result: RoundResult,
                probe_ids: Optional[np.ndarray],
                probe_states: Optional[np.ndarray]) -> None:
        if probe_states is None:
            return
        feats = self.fs.featurize(probe_states)
        pf, pmask = pad_cohort(feats)
        if self._pending is not None:
            lf, lmask, laction, lreward = self._pending
            self.replay.add(Transition(lf, lmask, laction, lreward, pf, pmask,
                                       k=ctx.k))
        action = np.zeros((MAX_COHORT,), np.float32)
        # indices within the probe cohort that were selected
        action[np.asarray(sorted({int(i) for i in self._last[2]}),
                          dtype=np.int64)] = 1.0
        self._pending = (pf, pmask, action, float(result.reward))
        self._rounds_seen += 1
        self.explore_eps *= self.explore_decay

        if not self.online or len(self.replay) < max(2, self.train_batch // 2):
            return
        step_losses, step_rl, step_rank = [], [], []
        with span("td_steps"):
            for _ in range(self.train_steps_per_round):
                batch = batch_transitions(self.replay.sample(self.train_batch),
                                          self.device)
                (self.q, self._opt_m, self._opt_v, self._opt_t, loss, aux
                 ) = self._train_step(self.q, self.q_target, self._opt_m,
                                      self._opt_v, self._opt_t, batch)
                step_losses.append(loss)
                step_rl.append(aux["l_rl"])
                step_rank.append(aux["l_rank"])
        # one metrics entry per round: the MEAN over this round's train steps
        # (one device->host copy for all of them)
        means = torch.stack([torch.stack(step_losses), torch.stack(step_rl),
                             torch.stack(step_rank)]).double().mean(1).tolist()
        for key, v in zip(("loss", "l_rl", "l_rank"), means):
            self.metrics[key].append(float(v))
        if self._rounds_seen % self.target_period == 0:
            self.q_target = hard_update(self.q_target, self.q)


def make_fedrank_variant(variant: str, qnet_params=None, **kw) -> FedRankPolicy:
    """Ablations: 'full', 'no_il' (-I), 'no_rank' (-P), 'no_il_no_rank' (-IP)."""
    if variant == "full":
        return FedRankPolicy(qnet_params, name="fedrank", **kw)
    if variant == "no_il":
        return FedRankPolicy(None, name="fedrank-I", **kw)
    if variant == "no_rank":
        return FedRankPolicy(qnet_params, use_rank_loss=False,
                             name="fedrank-P", **kw)
    if variant == "no_il_no_rank":
        return FedRankPolicy(None, use_rank_loss=False, name="fedrank-IP", **kw)
    raise ValueError(variant)
