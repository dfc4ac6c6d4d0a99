"""The per-device Q-network: a three-layer MLP (paper §3.2) scoring each
candidate device from its cohort-normalized state features.

VDN decomposition: the cohort value is the SUM of per-device Q-values of the
taken actions, so the net is applied device-wise and shared across devices.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.core.features import FEATURE_DIM
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def init_qnet(seed: int = 0, in_dim: int = FEATURE_DIM, hidden: int = 64,
              device: DeviceLike = None) -> Params:
    """Fresh Q-net weights from ``torch.Generator().manual_seed(seed)`` on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
    return {
        "w1": dense_init(gen, in_dim, hidden, dev),
        "b1": zeros(hidden),
        "w2": dense_init(gen, hidden, hidden, dev),
        "b2": zeros(hidden),
        "w3": dense_init(gen, hidden, 1, dev),
        "b3": zeros(1),
    }


def apply_qnet(p: Params, feats: torch.Tensor) -> torch.Tensor:
    """feats: (..., F) -> scores (...,)."""
    h = torch.relu(feats @ p["w1"] + p["b1"])
    h = torch.relu(h @ p["w2"] + p["b2"])
    return (h @ p["w3"] + p["b3"])[..., 0]


def soft_update(target: Params, online: Params, tau: float = 1.0) -> Params:
    """Periodic (tau=1) or Polyak (tau<1) target-network update."""
    return {k: (1 - tau) * t + tau * online[k] for k, t in target.items()}


def hard_update(target: Params, online: Params) -> Params:
    """Periodic target-network copy (``target`` keeps the call sites'
    shape)."""
    return {k: v.detach().clone() for k, v in online.items()}
