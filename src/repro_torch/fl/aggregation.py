"""Server-side aggregation: the data-size-weighted FedAvg mean, the
Byzantine-robust reducers and the asynchronous engine's staleness-weighted
buffer merge.

:func:`fedavg` accumulates each leaf in fp32 in client order and casts it
back to the leaf's dtype, as the reference does.  Every reducer walks the
params as a tree (:mod:`repro_torch.fl._tree`), so a nested LM model merges
like a flat MLP.  The robust reducers defend the merge against the attacks
in :mod:`repro_torch.fl.attacks`: :func:`trimmed_mean` (coordinate-wise
trimmed weighted mean), :func:`coordinate_median` and :func:`krum` /
:func:`multi_krum` (distance-score selection), dispatched by
:func:`robust_aggregate` (``FLConfig.aggregator``); ``"mean"`` is exactly
:func:`fedavg`.  They keep the reference's order semantics: ranks from a
stable double argsort, the median of an even count the mean of the two
middle values, Krum scores in fp64 with the first index on ties and a
stable sort for Multi-Krum.  Everything runs on the params' device except
the (m, m) Krum score table, which comes to the host for numpy's order
rules.

The asynchronous engine merges a *buffer* of updates that started from
different global-model versions, so each update is also scaled by a
staleness weight of its version lag (:func:`staleness_weight`,
FedBuff/FedAsync-style) in :func:`buffered_aggregate`; an update that
crossed several aggregation tiers carries the product of their weights
(:func:`compose_staleness`).  :func:`weighted_delta_aggregate` is the FedOpt
server step over the same mean.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.fl._tree import tree_leaves, tree_map

Params = Dict[str, torch.Tensor]

AGGREGATORS = ("mean", "trimmed_mean", "coordinate_median", "krum",
               "multi_krum")

STALENESS_KINDS = ("constant", "polynomial", "hinge")


def fedavg(client_params: Sequence[Params], weights: Sequence[float]) -> Params:
    """Data-size-weighted parameter average (McMahan et al., 2017)."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()

    def combine(*leaves):
        acc = leaves[0].float() * float(w[0])
        for wi, leaf in zip(w[1:], leaves[1:]):
            acc = acc + leaf.float() * float(wi)
        return acc.to(leaves[0].dtype)

    return tree_map(combine, *client_params)


def _stack(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """(m, ...) fp32 stack of one leaf over the clients."""
    return torch.stack([leaf.float() for leaf in leaves])


def trimmed_mean(client_params: Sequence[Params], weights: Sequence[float],
                 trim: int = 1) -> Params:
    """Coordinate-wise trimmed weighted mean (Yin et al., 2018): per
    coordinate the ``trim`` largest and ``trim`` smallest client values are
    dropped and the rest averaged with their renormalized data weights.
    Ranks come from a stable double argsort, so equal values keep client
    order.  ``trim=0`` is :func:`fedavg`."""
    m = len(client_params)
    if trim == 0:
        return fedavg(client_params, weights)
    if trim < 0 or 2 * trim >= m:
        raise ValueError(f"trimmed_mean needs 0 <= 2*trim < n updates; "
                         f"got trim={trim} with {m} updates")
    w = np.asarray(weights, np.float64)
    w = (w / w.sum()).astype(np.float32)

    def combine(*leaves):
        stack = _stack(leaves)
        ranks = torch.argsort(torch.argsort(stack, dim=0, stable=True),
                              dim=0, stable=True)
        keep = (ranks >= trim) & (ranks < m - trim)
        wb = torch.as_tensor(w, device=stack.device).view((m,) + (1,) * (stack.dim() - 1))
        kept_w = torch.where(keep, wb, torch.zeros((), device=stack.device))
        return ((kept_w * stack).sum(dim=0) / kept_w.sum(dim=0)).to(leaves[0].dtype)

    return tree_map(combine, *client_params)


def coordinate_median(client_params: Sequence[Params]) -> Params:
    """Coordinate-wise (unweighted) median of the client updates; an even
    count gives the mean of the two middle values (``torch.median`` would
    give the lower one).  Data weights are ignored on purpose: a weighted
    median would let an adversary claiming a huge dataset drag it."""
    m = len(client_params)

    def combine(*leaves):
        srt = torch.sort(_stack(leaves), dim=0).values
        mid = srt[m // 2] if m % 2 else (srt[m // 2 - 1] + srt[m // 2]) * 0.5
        return mid.to(leaves[0].dtype)

    return tree_map(combine, *client_params)


def krum_scores(client_params: Sequence[Params], f: int = 1) -> np.ndarray:
    """(m,) Krum scores (Blanchard et al., 2017): each update's summed
    squared distance to its ``m - f - 2`` nearest peers (at least 1).  The
    updates are flattened leaf by leaf in the reference's leaf order and the
    distances accumulate in fp64 on the params' device; the (m, m) table
    comes to the host for the sort."""
    m = len(client_params)
    flat = torch.stack([torch.cat([leaf.double().reshape(-1)
                                   for leaf in tree_leaves(p)])
                        for p in client_params])
    sq = torch.stack([((flat - flat[i]) ** 2).sum(dim=1) for i in range(m)])
    sq = sq.cpu().numpy()
    np.fill_diagonal(sq, np.inf)
    n_near = max(m - f - 2, 1)
    return np.sort(sq, axis=1)[:, :n_near].sum(axis=1)


def krum(client_params: Sequence[Params], f: int = 1) -> Params:
    """The update with the lowest Krum score (lowest index on ties)."""
    return client_params[int(np.argmin(krum_scores(client_params, f=f)))]


def multi_krum(client_params: Sequence[Params], weights: Sequence[float],
               f: int = 1, m_select: Optional[int] = None) -> Params:
    """Multi-Krum: :func:`fedavg` of the ``m_select`` lowest-scoring updates
    (default ``m - f``; stable order on equal scores) with their data
    weights."""
    m = len(client_params)
    if m_select is None:
        m_select = max(m - f, 1)
    m_select = int(np.clip(m_select, 1, m))
    keep = np.argsort(krum_scores(client_params, f=f), kind="stable")[:m_select]
    w = np.asarray(weights, np.float64)
    return fedavg([client_params[i] for i in keep], w[keep])


def robust_aggregate(client_params: Sequence[Params],
                     weights: Sequence[float], kind: str = "mean",
                     trim: int = 1, f: int = 1,
                     m_select: Optional[int] = None) -> Params:
    """Dispatch an aggregation ``kind`` from :data:`AGGREGATORS`.
    ``"mean"`` is exactly :func:`fedavg`; ``trim`` is clipped to
    ``(m - 1) // 2`` and Krum's ``f`` to ``(m - 3) // 2``, so small buffers
    degrade gracefully instead of raising."""
    m = len(client_params)
    if kind == "mean":
        return fedavg(client_params, weights)
    if kind == "trimmed_mean":
        return trimmed_mean(client_params, weights,
                            trim=int(np.clip(trim, 0, max((m - 1) // 2, 0))))
    if kind == "coordinate_median":
        return coordinate_median(client_params)
    f_eff = int(np.clip(f, 0, max((m - 3) // 2, 0)))
    if kind == "krum":
        return krum(client_params, f=f_eff)
    if kind == "multi_krum":
        return multi_krum(client_params, weights, f=f_eff, m_select=m_select)
    raise ValueError(f"unknown aggregator {kind!r}; "
                     f"expected one of {AGGREGATORS}")


def staleness_weight(lag, kind: str = "constant", a: float = 0.5,
                     b: int = 4) -> np.ndarray:
    """s(lag) in (0, 1]: how much an update dispatched ``lag`` global-model
    versions ago still counts.

    * ``constant``   — s = 1 (staleness ignored; FedBuff's unweighted mean)
    * ``polynomial`` — s = (1 + lag)^-a  (FedAsync's polynomial decay)
    * ``hinge``      — s = 1 while lag <= b, then 1 / (1 + a * (lag - b))
    """
    lag = np.asarray(lag, dtype=np.float64)
    if kind == "constant":
        return np.ones_like(lag)
    if kind == "polynomial":
        return (1.0 + lag) ** (-a)
    if kind == "hinge":
        return np.where(lag <= b, 1.0, 1.0 / (1.0 + a * np.maximum(lag - b, 0.0)))
    raise ValueError(f"unknown staleness kind {kind!r}; "
                     f"expected one of {STALENESS_KINDS}")


def compose_staleness(lags_by_tier: Sequence, kind: str = "constant",
                      a: float = 0.5, b: int = 4) -> np.ndarray:
    """Effective staleness weight of an update that crossed several
    aggregation tiers: the product of each tier's :func:`staleness_weight`
    (e.g. ``[region_lags, root_lags]`` in a hierarchical topology; arrays
    broadcast).  One tier is :func:`staleness_weight`; lag 0 weighs exactly
    1 at every tier."""
    out = None
    for lags in lags_by_tier:
        s = staleness_weight(np.asarray(lags), kind=kind, a=a, b=b)
        out = s if out is None else out * s
    if out is None:
        raise ValueError("compose_staleness needs at least one tier of lags")
    return out


def buffered_aggregate(global_params: Params, client_params: Sequence[Params],
                       data_weights: Sequence[float], lags: Sequence[int],
                       kind: str = "constant", a: float = 0.5, b: int = 4,
                       robust: str = "mean", trim: int = 1, f: int = 1,
                       m_select: Optional[int] = None) -> Params:
    """Staleness-weighted merge of a buffer of async updates.

    Update i carries ``c_i = w_i * s(lag_i)``, ``w_i`` its normalized data
    weight and ``s`` the staleness weight; the new global model is
    ``(1 - sum(c)) * global + sum(c_i * p_i)``, accumulated leaf by leaf in
    fp32 in buffer order — the mass a stale update loses stays with the
    current global model.  ``kind="constant"`` is exactly :func:`fedavg` of
    the buffer (the sync/async parity anchor).

    A ``robust`` kind other than ``"mean"`` reduces the buffer with
    :func:`robust_aggregate` under the staleness-scaled weights
    ``w_i * s(lag_i)`` and blends the result with the global model by the
    retained mass ``shrink = sum(w_norm_i * s_i)``; under constant weights
    it is the robust reduction itself.
    """
    s = staleness_weight(np.asarray(lags), kind=kind, a=a, b=b)
    w = np.asarray(data_weights, np.float64)
    if robust != "mean":
        if kind == "constant":
            return robust_aggregate(client_params, data_weights, kind=robust,
                                    trim=trim, f=f, m_select=m_select)
        shrink = float(((w / w.sum()) * s).sum())
        reduced = robust_aggregate(client_params, w * s, kind=robust,
                                   trim=trim, f=f, m_select=m_select)
        return tree_map(lambda g, r: (g.float() * (1.0 - shrink)
                                      + r.float() * shrink).to(g.dtype),
                        global_params, reduced)
    if kind == "constant":
        return fedavg(client_params, data_weights)
    coef = (w / w.sum()) * s
    keep = float(1.0 - coef.sum())

    def combine(g, *leaves):
        acc = g.float() * keep
        for ci, leaf in zip(coef, leaves):
            acc = acc + leaf.float() * float(ci)
        return acc.to(g.dtype)

    return tree_map(combine, global_params, *client_params)


def weighted_delta_aggregate(global_params: Params,
                             client_params: Sequence[Params],
                             weights: Sequence[float],
                             server_lr: float = 1.0) -> Params:
    """FedOpt-style: apply the weighted mean of client deltas with a server
    step size (reduces to fedavg at server_lr=1)."""
    avg = fedavg(client_params, weights)
    return tree_map(lambda g, a: (g.float() + server_lr * (a.float() - g.float())
                                  ).to(g.dtype), global_params, avg)
