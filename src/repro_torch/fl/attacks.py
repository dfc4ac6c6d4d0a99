"""Adversarial client attacks: corrupt updates between training and merge.

An :class:`AttackModel` rides on a scenario like its failure model: a
*static* ``round(fraction * n)``-device subset of the fleet is compromised
(:meth:`AttackModel.adversary_mask`, deterministic in ``(n, seed)``), each
round's draw restricts it to the selected ids (:meth:`AttackModel.draw`),
and :meth:`AttackModel.corrupt` maps an honestly trained upload to its
poisoned version after local training and before (buffered) aggregation,
relative to the dispatch-time global model.

Every draw comes from a dedicated numpy stream (:func:`attack_rng`, keyed
``(salt, seed, round, cid)``) that never touches the engines' generators,
so a run with no attack consumes exactly the RNG of an unattacked one; the
streams are the reference's, so membership, draws and noise equal its own.
The delta arithmetic runs in fp32 on the params' device.

Concrete attacks: :class:`SignFlip` (boosted update reversal),
:class:`ScaledUpdate` (model-replacement boosting), :class:`GaussianNoise`
(additive parameter noise, drawn leaf by leaf in the reference's leaf
order: dict keys sorted, recursively) and :class:`LabelSkewDrift` (the classifier-head
update rolled along the label axis on the round clock).  Defenses live in
:mod:`repro_torch.fl.aggregation`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.fl._tree import tree_leaves, tree_map, tree_unflatten

Params = Dict[str, torch.Tensor]

# salt for the dedicated attack RNG stream (the reference's value)
_ATTACK_SALT = 0xAD7E


def attack_rng(seed: int, round_idx: int, cid: int = -1) -> np.random.Generator:
    """The attack stream, deterministic in ``(seed, round_idx[, cid])``.
    ``round_idx=-1`` keys the round-independent membership draw, ``cid=-1``
    the per-round draw; both sentinels are shifted by one because
    SeedSequence entropy must be non-negative."""
    return np.random.default_rng([_ATTACK_SALT, abs(int(seed)),
                                  int(round_idx) + 1, int(cid) + 1])


@dataclass(frozen=True)
class AttackModel:
    """Base attack: a static adversarial subset and an update corruption.

    ``fraction`` of the fleet (rounded to a device count) is adversarial for
    the whole run.  The base class corrupts nothing (the ``fraction=0``
    identity); subclasses implement :meth:`corrupt`.
    """

    fraction: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.fraction <= 1.0:
            raise ValueError(f"attack fraction must be in [0, 1], "
                             f"got {self.fraction}")

    def n_adversaries(self, n: int) -> int:
        return int(round(self.fraction * n))

    def adversary_mask(self, n: int, seed: int) -> np.ndarray:
        """(n,) bool: the static compromised subset."""
        mask = np.zeros(n, dtype=bool)
        k = self.n_adversaries(n)
        if k:
            mask[attack_rng(seed, -1).permutation(n)[:k]] = True
        return mask

    def draw(self, n: int, seed: int, round_idx: int,
             ids: np.ndarray) -> np.ndarray:
        """(len(ids),) bool: which of the round's selected ``ids`` are
        adversarial (the static mask gathered at ``ids``)."""
        ids = np.asarray(ids, dtype=np.int64)
        return self.adversary_mask(n, seed)[ids]

    def corrupt(self, params: Params, global_params: Params, *, cid: int,
                seed: int, round_idx: int) -> Params:
        """Poisoned upload for one adversarial client, deterministic in
        ``(seed, round_idx, cid)``."""
        return params


def _map_delta(params: Params, global_params: Params,
               fn: Callable[[torch.Tensor], torch.Tensor]) -> Params:
    """p -> g + fn(p - g) per leaf, in fp32, keeping each leaf's dtype."""
    def one(p, g):
        g32 = g.float()
        return (g32 + fn(p.float() - g32)).to(p.dtype)
    return tree_map(one, params, global_params)


@dataclass(frozen=True)
class SignFlip(AttackModel):
    """Boosted update reversal: upload ``g - scale * (p - g)``."""

    scale: float = 1.0

    def corrupt(self, params, global_params, *, cid, seed, round_idx):
        return _map_delta(params, global_params, lambda d: -self.scale * d)


@dataclass(frozen=True)
class ScaledUpdate(AttackModel):
    """Model-replacement boosting: upload ``g + factor * (p - g)``."""

    factor: float = 10.0

    def corrupt(self, params, global_params, *, cid, seed, round_idx):
        return _map_delta(params, global_params, lambda d: self.factor * d)


@dataclass(frozen=True)
class GaussianNoise(AttackModel):
    """Additive parameter noise: upload ``p + sigma * z``, ``z`` standard
    normal from :func:`attack_rng` keyed by ``(seed, round, cid)``, drawn
    leaf by leaf in the reference's leaf order (keys sorted, recursively)."""

    sigma: float = 1.0

    def corrupt(self, params, global_params, *, cid, seed, round_idx):
        rng = attack_rng(seed, round_idx, cid)

        def one(p):
            z = rng.standard_normal(tuple(p.shape)).astype(np.float32)
            return (p.float() + self.sigma
                    * torch.as_tensor(z, device=p.device)).to(p.dtype)
        return tree_unflatten(params, [one(p) for p in tree_leaves(params)])


@dataclass(frozen=True)
class LabelSkewDrift(AttackModel):
    """Per-round label-distribution rotation on the round clock: the update
    of every leaf whose trailing dimension is the label axis is rolled by
    ``(round // period) % C`` classes.  The label axis is the trailing
    dimension of the last leaf in the reference's leaf order (its
    structurally-last leaf: an MLP's ``w3``, an LM's ``lm_head``)."""

    period: int = 1

    def __post_init__(self):
        super().__post_init__()
        if self.period < 1:
            raise ValueError(f"drift period must be >= 1, got {self.period}")

    def shift(self, round_idx: int, n_classes: int) -> int:
        return (int(round_idx) // self.period) % max(int(n_classes), 1)

    def corrupt(self, params, global_params, *, cid, seed, round_idx):
        leaves = tree_leaves(params)
        n_classes = int(leaves[-1].shape[-1]) if leaves else 0
        k = self.shift(round_idx, n_classes)
        if k == 0:
            return params

        def roll_head(d):
            if d.dim() and d.shape[-1] == n_classes:
                return torch.roll(d, k, dims=-1)
            return d
        return _map_delta(params, global_params, roll_head)
