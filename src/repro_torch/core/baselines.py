"""Baseline selection policies.  This package has the random baseline
(FedAvg / FedProx selection — the prox term itself is ``FLConfig.prox_mu``);
the heuristic and learning baselines come in a later slice."""
from __future__ import annotations

import numpy as np

from repro_torch.fl.server import RoundContext


class RandomPolicy:
    """FedAvg / FedProx selection: uniform random K of N (online only)."""

    needs_probing = False

    def __init__(self, name: str = "fedavg"):
        self.name = name

    def select(self, ctx: RoundContext, probe_ids, probe_states) -> np.ndarray:
        avail = ctx.available_ids()
        return ctx.rng.choice(avail, size=min(ctx.k, len(avail)), replace=False)

    def observe(self, ctx, result, probe_ids, probe_states) -> None:
        pass
