"""Analytical expert scorers (the IL teachers, paper Alg. 1 line 4).

Each expert maps a cohort's probe states to a utility score per device; the
ranking induced by these scores is what FedRank's Q-net is pre-trained to
imitate.  Three experts, as in the paper:

* **Oort** (Lai et al., OSDI'21) — faithful Eq. (10): statistical utility
  |B_i| * sqrt(mean loss^2) times a global-system latency penalty.
* **Harmony** (Tian et al., MICRO'22) — re-implemented in spirit: a
  multi-objective z-score blend of statistical utility, latency and energy
  (the full hierarchical manager is out of scope).
* **FedMarl-like** (Zhang et al., AAAI'22) — probing-loss-driven marginal
  utility with latency and communication-cost penalties, mirroring the terms
  of its reward (Eq. 11) as a greedy analytical score.

All scorers take the (M, 6) raw state matrix
(T_comp, T_comm, E_comp, E_comm, L_i, D_i) and per-device round estimates.
Host numpy, the same arithmetic as the reference's ``repro.core.experts``,
so the scores are bit-for-bit equal.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core.features import STATE_DIM

EXPERTS: Dict[str, Callable] = {}


def _register(name):
    def deco(fn):
        EXPERTS[name] = fn
        return fn
    return deco


def _z(x: np.ndarray) -> np.ndarray:
    return (x - x.mean()) / (x.std() + 1e-9)


def _round_time(states: np.ndarray, l_ep: int) -> np.ndarray:
    return states[:, 1] + states[:, 0] * l_ep


def _round_energy(states: np.ndarray, l_ep: int) -> np.ndarray:
    return states[:, 3] + states[:, 2] * l_ep


@_register("oort")
def oort_utility(states: np.ndarray, *, l_ep: int = 5, alpha: float = 2.0,
                 t_budget: float | None = None, **_) -> np.ndarray:
    """Eq. (10).  With mean-loss probes, |B_i| sqrt(1/|B_i| sum loss_k^2)
    ~= D_i * L_i (we observe the mean; document the substitution)."""
    d = states[:, 5]
    loss = states[:, 4]
    stat = d * np.sqrt(np.maximum(loss, 0.0) ** 2 + 1e-12)
    t_i = _round_time(states, l_ep)
    t = t_budget if t_budget is not None else float(np.median(t_i))
    sys_util = np.where(t < t_i, (t / np.maximum(t_i, 1e-9)) ** alpha, 1.0)
    return stat * sys_util


@_register("harmony")
def harmony_utility(states: np.ndarray, *, l_ep: int = 5, w_stat: float = 1.0,
                    w_lat: float = 0.7, w_energy: float = 0.7, **_) -> np.ndarray:
    """Multi-objective blend (heterogeneity-aware hierarchical manager,
    flattened to its scoring essence)."""
    stat = _z(np.log1p(states[:, 5]) * np.maximum(states[:, 4], 0.0))
    lat = _z(np.log1p(_round_time(states, l_ep)))
    en = _z(np.log1p(_round_energy(states, l_ep)))
    return w_stat * stat - w_lat * lat - w_energy * en


@_register("fedmarl")
def fedmarl_utility(states: np.ndarray, *, l_ep: int = 5, w1: float = 1.0,
                    w2: float = 0.6, w3: float = 0.4, **_) -> np.ndarray:
    """Probing-based greedy analogue of FedMarl's reward terms: statistical
    gain proxy (probe loss) minus processing-latency and comm-cost terms."""
    gain = _z(np.maximum(states[:, 4], 0.0))
    lat = _z(np.log1p(states[:, 0] * (l_ep - 1) + states[:, 1]))
    comm = _z(np.log1p(states[:, 3]))
    return w1 * gain - w2 * lat - w3 * comm


def expert_scores(name: str, states: np.ndarray, **kw) -> np.ndarray:
    """Score a cohort with the named expert.  Every feature set puts the
    paper's 6 columns first (repro_torch.core.features), so wider state
    matrices (e.g. ``"telemetry"``) are sliced down to the block the
    analytical scorers are defined on."""
    return EXPERTS[name](np.asarray(states)[:, :STATE_DIM], **kw)
