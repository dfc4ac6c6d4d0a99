"""Server-side aggregation: the data-size-weighted FedAvg mean.

:func:`fedavg` accumulates each leaf in fp32 in client order, as the
reference does.  :func:`robust_aggregate` takes ``kind="mean"`` only; the
Byzantine-robust reducers come with the robustness slice.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

Params = Dict[str, torch.Tensor]

AGGREGATORS = ("mean",)


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
