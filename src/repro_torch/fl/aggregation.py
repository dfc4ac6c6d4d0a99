"""Server-side aggregation: the data-size-weighted FedAvg mean and the
asynchronous engine's staleness-weighted buffer merge.

:func:`fedavg` accumulates each leaf in fp32 in client order, as the
reference does.  The asynchronous engine merges a *buffer* of updates that
started from different global-model versions, so each update is also scaled
by a staleness weight of its version lag (:func:`staleness_weight`,
FedBuff/FedAsync-style) in :func:`buffered_aggregate`.
:func:`weighted_delta_aggregate` is the FedOpt server step over the same mean.
:func:`robust_aggregate` and :func:`buffered_aggregate` take
``kind="mean"`` / ``robust="mean"`` only; the Byzantine-robust reducers come
with the robustness slice.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

AGGREGATORS = ("mean",)

STALENESS_KINDS = ("constant", "polynomial", "hinge")


def fedavg(client_params: Sequence[Params], weights: Sequence[float]) -> Params:
    """Data-size-weighted parameter average (McMahan et al., 2017)."""
    w = np.asarray(weights, np.float64)
    w = w / w.sum()
    out = {}
    for name in client_params[0]:
        leaves = [p[name] for p in client_params]
        acc = leaves[0].float() * float(w[0])
        for wi, leaf in zip(w[1:], leaves[1:]):
            acc = acc + leaf.float() * float(wi)
        out[name] = acc.to(leaves[0].dtype)
    return out


def robust_aggregate(client_params: Sequence[Params],
                     weights: Sequence[float], kind: str = "mean") -> Params:
    """``"mean"`` is :func:`fedavg`; other kinds are not ported yet."""
    if kind == "mean":
        return fedavg(client_params, weights)
    raise NotImplementedError(
        f"aggregator {kind!r} comes with the robustness slice of the port; "
        f"this package has {AGGREGATORS}")


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


def buffered_aggregate(global_params: Params, client_params: Sequence[Params],
                       data_weights: Sequence[float], lags: Sequence[int],
                       kind: str = "constant", a: float = 0.5, b: int = 4,
                       robust: str = "mean") -> Params:
    """Staleness-weighted merge of a buffer of async updates.

    Update i carries ``c_i = w_i * s(lag_i)``, ``w_i`` its normalized data
    weight and ``s`` the staleness weight; the new global model is
    ``(1 - sum(c)) * global + sum(c_i * p_i)``, accumulated leaf by leaf in
    fp32 in buffer order — the mass a stale update loses stays with the
    current global model.  ``kind="constant"`` is exactly :func:`fedavg` of
    the buffer (the sync/async parity anchor).  ``robust`` other than
    ``"mean"`` comes with the robustness slice.
    """
    if robust != "mean":
        raise NotImplementedError(
            f"buffered aggregation with robust={robust!r} comes with the "
            f"robustness slice of the port; this package has {AGGREGATORS}")
    s = staleness_weight(np.asarray(lags), kind=kind, a=a, b=b)
    if kind == "constant":
        return fedavg(client_params, data_weights)
    w = np.asarray(data_weights, np.float64)
    coef = (w / w.sum()) * s
    keep = float(1.0 - coef.sum())
    out = {}
    for name, g in global_params.items():
        acc = g.float() * keep
        for ci, p in zip(coef, client_params):
            acc = acc + p[name].float() * float(ci)
        out[name] = acc.to(g.dtype)
    return out


def weighted_delta_aggregate(global_params: Params,
                             client_params: Sequence[Params],
                             weights: Sequence[float],
                             server_lr: float = 1.0) -> Params:
    """FedOpt-style: apply the weighted mean of client deltas with a server
    step size (reduces to fedavg at server_lr=1)."""
    avg = fedavg(client_params, weights)
    return {name: (g.float() + server_lr * (avg[name].float() - g.float())).to(g.dtype)
            for name, g in global_params.items()}
