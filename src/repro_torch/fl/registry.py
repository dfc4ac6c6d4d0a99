"""Selection-policy registry: build any ported policy by name.

    from repro_torch.fl.registry import build_policy
    policy = build_policy("fedrank", k=10)

Registered names (see :func:`available_policies`):

* ``fedavg`` / ``random`` / ``fedprox`` — uniform random K of N (pair
  ``fedprox`` with ``FLConfig.prox_mu > 0``);
* ``afl``, ``tifl``, ``oort``, ``oort-telemetry``, ``favor``, ``fedmarl`` —
  the paper's heuristic and learning baselines (``favor`` takes
  ``device=...`` for its Q-net);
* ``fedrank``, ``fedrank-I``, ``fedrank-P``, ``fedrank-IP`` — the paper's
  policy and its no-IL / no-rank-loss / plain-DQN ablations (pass
  ``qnet=...`` for IL-pretrained weights from
  :func:`repro_torch.core.imitation.pretrain_qnet` and ``device=...`` for
  where a fresh Q-net lives);
* ``expert-oort``, ``expert-harmony``, ``expert-fedmarl`` — the analytical
  IL teachers wrapped as probing policies.

Any other name raises ``KeyError`` listing these.  :func:`register_policy`
adds a factory under a new name.
"""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.fl.server import SelectionPolicy

_POLICIES: Dict[str, Callable[..., SelectionPolicy]] = {}
_populated = False


def _populate() -> None:
    """Register the built-in policies on first use (``repro_torch.core``
    imports ``repro_torch.fl``, so registering lazily keeps both packages
    importable in either order)."""
    global _populated
    if _populated:
        return
    from repro_torch.core.baselines import (
        AFLPolicy,
        ExpertPolicy,
        FavorPolicy,
        FedMarlPolicy,
        OortPolicy,
        OortTelemetryPolicy,
        RandomPolicy,
        TiFLPolicy,
    )
    from repro_torch.core.experts import EXPERTS
    from repro_torch.core.fedrank import make_fedrank_variant

    def fedrank(variant: str):
        def factory(qnet=None, **kw):
            return make_fedrank_variant(variant, qnet, **kw)
        return factory

    builtin = {
        "fedavg": lambda **kw: RandomPolicy("fedavg", **kw),
        "random": lambda **kw: RandomPolicy("random", **kw),
        "fedprox": lambda **kw: RandomPolicy("fedprox", **kw),
        "afl": AFLPolicy,
        "tifl": TiFLPolicy,
        "oort": OortPolicy,
        "oort-telemetry": OortTelemetryPolicy,
        "favor": FavorPolicy,
        "fedmarl": FedMarlPolicy,
        "fedrank": fedrank("full"),
        "fedrank-I": fedrank("no_il"),
        "fedrank-P": fedrank("no_rank"),
        "fedrank-IP": fedrank("no_il_no_rank"),
    }
    for expert in EXPERTS:
        builtin[f"expert-{expert}"] = (
            lambda _e=expert, **kw: ExpertPolicy(_e, **kw))
    # setdefault: a name registered before first use wins, as in the reference
    for name, factory in builtin.items():
        _POLICIES.setdefault(name, factory)
    _populated = True


def register_policy(name: str, factory: Callable[..., SelectionPolicy]) -> None:
    """Register a policy factory under ``name`` (kwargs pass through);
    a name already registered raises ``ValueError``."""
    if name in _POLICIES:
        raise ValueError(f"policy {name!r} already registered")
    _POLICIES[name] = factory


def build_policy(name: str, **kw) -> SelectionPolicy:
    """Construct the named policy; kwargs go to its constructor."""
    _populate()
    try:
        factory = _POLICIES[name]
    except KeyError:
        raise KeyError(f"unknown policy {name!r}; "
                       f"registered: {available_policies()}") from None
    return factory(**kw)


def available_policies() -> List[str]:
    _populate()
    return sorted(_POLICIES)
