"""Public op: top-K cohort selection — THE selection path of the port.

``select_topk(scores_fn, states, mask, k)`` has three scoring modes and one
contract (candidates by score descending, exact ties toward the LOWEST
index, masked candidates excluded, exactly ``min(k, n_valid)`` winners):

* ``scores_fn`` is a Q-net params dict (w1/b1/w2/b2/w3/b3) — the fused path.
  The params' device decides: on the card one C call
  (:func:`~repro_torch.kernels.select_topk.kernel.select_topk_host`) uploads
  states, mask and bias from one pinned record buffer, launches the kernel
  once and downloads the winners; on the CPU the plain version scores and
  selects.
* ``scores_fn`` is a callable — analytical utilities: scored in one call,
  then partial-selected on the host (:func:`topk_indices`).
* ``scores_fn`` is None — ``states`` already ARE the scores.

``masked_topk`` is the tensor sibling for the double-Q bootstrap in
:mod:`repro_torch.core.dqn`, with the same masking and tie rule.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.select_topk.kernel import select_topk_host
from repro_torch.kernels.select_topk.ref import NEG_INF, stable_topk
from repro_torch.obs.profiling import timed_call


def masked_topk(scores: torch.Tensor, mask: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values (..., k), indices (..., k)) by score descending along the last
    dim, masked entries sunk to ``NEG_INF``, ties and exhausted slots
    resolving toward the lowest index."""
    s = torch.where(mask > 0, scores, torch.full_like(scores, NEG_INF))
    return stable_topk(s, k)


def topk_indices(scores: np.ndarray, k: int,
                 mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Host partial-select: indices of the k largest scores, descending,
    lowest-index tie-breaking — equal to ``np.argsort(-s, kind="stable")
    [:k]`` without the full sort."""
    s = np.asarray(scores)
    if mask is not None:
        s = np.where(np.asarray(mask) > 0, s, -np.inf)
    n = s.shape[0]
    k = min(int(k), n)
    if k <= 0:
        return np.empty(0, np.int64)
    if k >= n:
        return np.argsort(-s, kind="stable").astype(np.int64)
    kth = np.partition(s, n - k)[n - k]          # k-th largest value
    above = np.flatnonzero(s > kth)              # strictly better: < k of them
    ties = np.flatnonzero(s == kth)              # ascending index already
    idx = np.concatenate([above, ties[: k - len(above)]])
    order = np.argsort(-s[idx], kind="stable")   # small: k entries
    return idx[order].astype(np.int64)


def select_topk(scores_fn: Union[dict, Callable[[np.ndarray], np.ndarray], None],
                states: np.ndarray,
                mask: Optional[np.ndarray],
                k: int,
                *,
                bias: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Select the top-``min(k, n_valid)`` candidates.

    Returns ``(indices, scores)`` as host arrays: int64 candidate indices by
    score descending and their float32 scores.  ``mask`` is an (N,) 0/1
    validity mask (None = all valid); ``bias`` an optional (N,) additive
    score adjustment applied after scoring.
    """
    states = np.asarray(states)
    n = states.shape[0]
    m = (np.ones(n, bool) if mask is None
         else np.asarray(mask).astype(bool))
    k_eff = min(int(k), int(m.sum()))
    if k_eff <= 0:
        return np.empty(0, np.int64), np.empty(0, np.float32)

    if isinstance(scores_fn, dict):              # fused Q-net path
        # timed_call is a passthrough unless a profiler is active
        # (repro_torch.obs.profiling): then the call's wall-clock (the C
        # call synchronises) lands in the run record's op table
        route = "cuda" if scores_fn["w1"].device.type == "cuda" else "plain"
        vals, idx = timed_call(f"select_topk.{route}", select_topk_host,
                               scores_fn, states, m, bias, k=min(int(k), n))
        return idx[:k_eff], vals[:k_eff]

    def _host_select():
        scores = states if scores_fn is None else np.asarray(scores_fn(states))
        scores = np.asarray(scores, np.float64)
        if bias is not None:
            scores = scores + np.asarray(bias, np.float64)
        idx = topk_indices(scores, k_eff, m)
        return idx, scores[idx]

    return timed_call("select_topk.host", _host_select)
