"""Plain reference of a synchronous FedRank / FedAvg round.

Written from the paper's description (probe a provisional cohort picked by
a per-device Q-net over cohort-normalised states, keep the top K, merge
their local SGD by the data-weighted mean, reward the round by Eq. 1 and
refine the Q-net online by a double-Q TD step with the pairwise ranking
term, Eq. 5), in plain PyTorch and NumPy.

It follows the program round by round.  Read from the program's log of
the round, taken before the program uses them: the fleet simulator's host
state (which devices are online, their latencies and energies, the round's
failures and simulated cost), the random stream of the policy's
exploration (the probes it adds at random are the program's), and the
probe losses that the cuts and the Q-net's
transitions are featurised from (the devices start a round from one model
on like data, so their losses lie within a few thousandths of each other,
and the cohort's z-scoring would turn the rounding of a bf16 loss into a
different feature).  Those probe losses are judged on their own, against
the reference's.  Everything else computed on the card is worked out again
here from the benchmark's own inputs: every trained client's SGD, the
merge, the evaluation, the Q-net's scores, the cohort cuts and the TD
steps.  The cohorts that go on to be trained are the program's (its choice
is judged, not replayed), so a near tie decided the other way does not send
the two runs apart.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.reference import model as M
from perfbench.reference.model import Precision

MAX_COHORT = 64


# ---------------------------------------------------------------------------
# features, Q-net, cuts
# ---------------------------------------------------------------------------


def featurize(states: np.ndarray) -> np.ndarray:
    """(M, 6) raw states (T_comp, T_comm, E_comp, E_comm, loss, data size) ->
    log-compressed where heavy-tailed, z-scored over the cohort."""
    s = np.asarray(states, np.float64)
    f = np.concatenate([np.log1p(np.maximum(s[:, 0:4], 0.0)), s[:, 4:5],
                        np.log1p(np.maximum(s[:, 5:6], 0.0))], axis=1)
    return ((f - f.mean(0, keepdims=True)) / (f.std(0, keepdims=True) + 1e-6)
            ).astype(np.float32)


def qnet(q: Dict[str, torch.Tensor], feats: torch.Tensor, dtype=torch.float32
         ) -> torch.Tensor:
    """Three-layer MLP score per device: (..., F) -> (...)."""
    w = {k: v.to(dtype) for k, v in q.items()}
    h = torch.relu(feats.to(dtype) @ w["w1"] + w["b1"])
    h = torch.relu(h @ w["w2"] + w["b2"])
    return (h @ w["w3"] + w["b3"])[..., 0].float()


def top_ids(scores: np.ndarray, valid: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k best valid scores, descending, ties to the lowest."""
    s = np.where(valid, scores.astype(np.float64), -np.inf)
    order = np.argsort(-s, kind="stable")
    return order[:min(k, int(valid.sum()))]


def cut_gap(chosen: np.ndarray, expected: np.ndarray, scores: np.ndarray) -> float:
    """How far a cut strays from the reference's: for each chosen candidate
    the reference did not choose, the nearest score among those it chose
    instead, as a share of the scores' spread; 0 when the sets agree."""
    extra = np.setdiff1d(chosen, expected)
    missed = np.setdiff1d(expected, chosen)
    if len(extra) == 0 and len(missed) == 0:
        return 0.0
    if len(extra) != len(missed):
        return float("inf")
    finite = scores[np.isfinite(scores)]
    scale = max(float(finite.std()), 1e-6)
    return max(float(np.min(np.abs(scores[missed] - scores[i]))) for i in extra) / scale


def paper_reward(d_acc, r_t, r_e, t_budget, e_budget, alpha=2.0, beta=2.0) -> float:
    r = d_acc
    if t_budget < r_t:
        r *= (t_budget / r_t) ** alpha
    if e_budget < r_e:
        r *= (e_budget / r_e) ** beta
    return float(r)


def _pad(feats: np.ndarray):
    out = np.zeros((MAX_COHORT, feats.shape[1]), np.float32)
    out[:len(feats)] = feats
    mask = np.zeros(MAX_COHORT, np.float32)
    mask[:len(feats)] = 1.0
    return out, mask


def td_loss(q, q_target, batch, *, gamma, rank_eps, k, dtype):
    """Double-Q TD loss on the VDN sum of the selected devices' values plus
    the pairwise RankNet term against the target net (Eqs. 2-5)."""
    feats, mask, action, reward, nfeats, nmask = batch
    qs = qnet(q, feats, dtype)
    pred = (qs * action).sum(-1)
    with torch.no_grad():
        online_next = torch.where(nmask > 0, qnet(q, nfeats, dtype),
                                  torch.full_like(nmask, -1e30))
        top = torch.sort(online_next, dim=-1, descending=True, stable=True)[1][..., :k]
        boot = qnet(q_target, nfeats, dtype).gather(-1, top).sum(-1)
        target = reward + gamma * boot
        tq = qnet(q_target, feats, dtype)
        soft = torch.sigmoid(tq[..., :, None] - tq[..., None, :])
    logits = qs[..., :, None] - qs[..., None, :]
    pm = mask[..., :, None] * mask[..., None, :] * (1 - torch.eye(mask.shape[-1],
                                                                  device=mask.device))
    bce = (torch.clamp(logits, min=0) - logits * soft
           + torch.log1p(torch.exp(-logits.abs())))
    l_rank = (bce * pm).sum((-2, -1)) / pm.sum((-2, -1)).clamp(min=1)
    return ((pred - target) ** 2 + rank_eps * l_rank).mean()


class QLearner:
    """The policy's online state: Q-net, target, Adam moments, replay."""

    def __init__(self, q0, pol: dict, k: int, seed: int, dtype):
        self.q = {n: t.detach().clone().float() for n, t in q0.items()}
        self.q_target = {n: t.clone() for n, t in self.q.items()}
        self.m = {n: torch.zeros_like(t) for n, t in self.q.items()}
        self.v = {n: torch.zeros_like(t) for n, t in self.q.items()}
        self.t = 0
        self.pol, self.k, self.dtype = pol, k, dtype
        self.replay: List[tuple] = []
        self.rng = np.random.default_rng(seed + 3)
        self.pending = None
        self.rounds = 0
        self.eps = pol["explore_eps"]

    def scores(self, feats: np.ndarray) -> np.ndarray:
        dev = self.q["w1"].device
        with torch.no_grad():
            return qnet(self.q, torch.as_tensor(feats, device=dev), self.dtype).cpu().numpy()

    def observe(self, feats: np.ndarray, chosen_pos: np.ndarray, reward: float) -> None:
        pol = self.pol
        pf, pmask = _pad(feats)
        if self.pending is not None:
            self.replay.append(self.pending[:4] + (pf, pmask))
            if len(self.replay) > pol["replay_capacity"]:
                self.replay.pop(0)
        action = np.zeros(MAX_COHORT, np.float32)
        action[np.unique(chosen_pos)] = 1.0
        self.pending = (pf, pmask, action, reward)
        self.rounds += 1
        self.eps *= pol["explore_decay"]
        if not pol["online"] or len(self.replay) < max(2, pol["train_batch"] // 2):
            return
        dev = self.q["w1"].device
        for _ in range(pol["train_steps_per_round"]):
            n = min(pol["train_batch"], len(self.replay))
            idx = self.rng.choice(len(self.replay), size=n,
                                  replace=len(self.replay) < 2 * n)
            trs = [self.replay[i] for i in idx]
            batch = tuple(torch.as_tensor(np.stack([tr[j] for tr in trs]).astype(np.float32),
                                          device=dev) for j in range(6))
            names = list(self.q)
            work = [self.q[n].clone().requires_grad_(True) for n in names]
            loss = td_loss(dict(zip(names, work)), self.q_target, batch,
                           gamma=pol["gamma"], rank_eps=pol["rank_eps"], k=self.k,
                           dtype=self.dtype)
            grads = torch.autograd.grad(loss, work)
            self.t += 1
            b1, b2, eps = 0.9, 0.999, 1e-8
            with torch.no_grad():
                for n, w, g in zip(names, work, grads):
                    self.m[n] = b1 * self.m[n] + (1 - b1) * g
                    self.v[n] = b2 * self.v[n] + (1 - b2) * g * g
                    self.q[n] = (w.detach() - pol["lr"] * (self.m[n] / (1 - b1 ** self.t))
                                 / (torch.sqrt(self.v[n] / (1 - b2 ** self.t)) + eps))
        if self.rounds % pol["target_period"] == 0:
            self.q_target = {n: t.clone() for n, t in self.q.items()}


# ---------------------------------------------------------------------------
# the rounds
# ---------------------------------------------------------------------------


def local_epoch(p, cfg, xs, ys, seed: int, batch: int, lr: float, prec: Precision):
    """One client's epoch: the shard walked in ``default_rng(seed)``'s
    permutation, ``batch`` rows a step.  Returns (params, mean step loss)."""
    n = len(ys)
    perm = np.random.default_rng(seed).permutation(n)
    losses = []
    for b in range(n // batch):
        sl = torch.as_tensor(perm[b * batch:(b + 1) * batch], device=xs.device)
        p, loss = M.sgd_step(p, cfg, xs[sl], ys[sl], lr, prec)
        losses.append(loss)
    return p, float(np.mean(losses))


def fedavg(params: List[dict], weights: List[float], prec: Precision) -> dict:
    w = np.asarray(weights, np.float64)
    w = w / w.sum()

    def merge(*ls):
        acc = sum(float(wi) * leaf.float() for wi, leaf in zip(w, ls))
        return prec.store(acc, ls[0].dtype)
    return M.tree_map(merge, *params)


def change_norms(p: dict, p0: dict) -> Dict[str, float]:
    """Each leaf's L2 norm of ``p - p0`` in float64."""
    a, b = M.leaves(p), M.leaves(p0)
    with torch.no_grad():
        return {n: float(torch.linalg.vector_norm(a[n].float() - b[n].float(),
                                                  dtype=torch.float64)) for n in a}


def follow(weights: dict, q0, fed, log: List[dict], cfg: dict, mix: dict,
           seed: int, prec: Precision = M.REFERENCE) -> dict:
    """Run the logged rounds from ``weights`` and return the record that
    :func:`perfbench.check.compare` reads: per round the trained clients'
    losses, the test loss, and for FedRank the two cuts it would make and
    the scores that judge them; the params' change after the first and the
    last round; the Q-net's change after the last."""
    dev = fed.train_x.device
    k, batch, lr = mix["k"], mix["local_batch"], mix["lr"]
    fedrank = mix["policy"] == "fedrank"
    pol = mix.get("policy_kwargs", {})
    p0 = weights
    p = weights
    acc0, _ = M.evaluate(p, cfg, fed.test_x, fed.test_y, prec)
    last_acc = acc0
    pol = dict(DEFAULT_FEDRANK, **pol)
    learner = QLearner(q0, pol, k, seed, prec.qnet_dtype) if fedrank else None
    rec = {"rounds": [], "weights": []}
    for r, lg in enumerate(log):
        out = {"client_loss": {}}
        survivors = np.asarray(lg["survivors"], np.int64)
        trained = {}
        if fedrank:
            ctx = lg["ctx"]
            _, m_top = probe_sizes(int(ctx["available"].sum()), k, pol["probe_factor"])
            book = np.stack([ctx["est_t"] / 5.0, ctx["t_comm"], ctx["est_e"] / 5.0,
                             ctx["e_comm"], ctx["last_loss"], ctx["data_sizes"]], 1)
            s_probe = learner.scores(featurize(book)) - 0.05 * np.sqrt(ctx["selection_count"])
            s_probe = np.where(ctx["available"], s_probe, -np.inf)
            top = top_ids(s_probe, ctx["available"], m_top)
            out["probe_top"] = top
            out["probe_scores"] = s_probe
            probe_ids = np.asarray(lg["probe_ids"], np.int64)
            losses = np.zeros(len(probe_ids))
            for j, cid in enumerate(probe_ids):
                xs, ys = fed.client(cid)
                pc, losses[j] = local_epoch(p, cfg, xs, ys, seed + 1000 * r + int(cid),
                                            batch, lr, prec)
                out["client_loss"][int(cid)] = losses[j]
                if cid in survivors:
                    trained[int(cid)] = pc
            raw = np.stack([ctx["t_comp"][probe_ids], ctx["t_comm"][probe_ids],
                            ctx["e_comp"][probe_ids], ctx["e_comm"][probe_ids],
                            np.asarray(lg["probe_losses"]), ctx["data_sizes"][probe_ids]], 1)
            feats = featurize(raw)
            s_sel = learner.scores(feats)
            order = top_ids(s_sel, np.ones(len(s_sel), bool), len(s_sel))
            pos = list(order[:k])
            rng = _rng(lg["rng_select"])
            if rng.random() < learner.eps and len(order) > k:
                swap_out = int(rng.integers(k))
                swap_in = int(rng.integers(k, len(order)))
                pos[swap_out] = order[swap_in]
            out["chosen"] = probe_ids[np.asarray(pos)]
            out["select_scores"] = dict(zip(probe_ids.tolist(), s_sel.tolist()))
        else:
            for cid in survivors:
                xs, ys = fed.client(cid)
                pc, loss = local_epoch(p, cfg, xs, ys, seed + 2000 * r + int(cid),
                                       batch, lr, prec)
                trained[int(cid)] = pc
                out["client_loss"][int(cid)] = loss
        if trained:
            p = fedavg([trained[int(i)] for i in survivors],
                       [float(fed.sizes[i]) for i in survivors], prec)
        acc, test_loss = M.evaluate(p, cfg, fed.test_x, fed.test_y, prec)
        out["test_loss"] = test_loss
        if fedrank:
            reward = paper_reward(acc - last_acc, lg["r_t"], lg["r_e"],
                                  lg["t_budget"], lg["e_budget"])
            idx_of = {int(c): j for j, c in enumerate(probe_ids)}
            chosen_pos = np.asarray([idx_of[int(c)] for c in lg["selected"]])
            learner.observe(feats, chosen_pos, reward)
        last_acc = acc
        if r == 0:
            rec["change_first"] = change_norms(p, p0)
        rec["rounds"].append(out)
    rec["change_last"] = change_norms(p, p0)
    if fedrank:
        rec["qnet_change"] = {n: float((learner.q[n].double() - q0[n].double()).norm())
                              for n in sorted(q0)}
    return rec


DEFAULT_FEDRANK = dict(gamma=0.9, rank_eps=0.5, lr=5e-4, explore_eps=0.1,
                       explore_decay=0.95, target_period=5, replay_capacity=512,
                       train_batch=8, train_steps_per_round=4, probe_factor=2.5,
                       online=True)


def probe_sizes(n_online: int, k: int, probe_factor: float):
    """(devices probed, of them picked by score): ``probe_factor * k``
    probes, at least k and at most 64, a fifth of them (at least one)
    exploration draws."""
    m = min(n_online, MAX_COHORT, max(k, int(round(k * probe_factor))))
    return m, m - max(1, m // 5)


def _rng(state: dict) -> np.random.Generator:
    g = np.random.default_rng()
    g.bit_generator.state = state
    return g
