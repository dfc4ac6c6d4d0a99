"""Heterogeneous mobile-device simulator (numpy, host side).

Devices are drawn from tiers (flagship / mid / low-end) with per-device
compute throughput, bandwidth and energy coefficients; per-round dynamics
(load, availability, failures) come from :mod:`repro_torch.fl.scenarios`;
a trace scenario's models carry the device their lookups run on.
The fleet is stored struct-of-arrays and every draw follows the reference's
RNG order, so availability masks, failure draws, latency and energy equal the
reference's for the same ``(scenario, n_devices, seed)``.

Latency/energy of a round for device i:
    T_comp,i = flops_per_epoch_i / (speed_i * load_i)       (per local epoch)
    T_comm,i = model_bytes * 2 / bw_i + overhead
    E_comp,i = flops_per_epoch_i * j_per_flop_i
    E_comm,i = model_bytes * 2 * j_per_byte_i
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class DeviceProfile:
    speed: float          # FLOP/s sustained
    bandwidth: float      # bytes/s (symmetrized up+down)
    j_per_flop: float
    j_per_byte: float
    tier: int


@dataclass
class RoundSystemState:
    """Per-device system observables for one round (before selection)."""

    t_comp: np.ndarray    # (N,) seconds per local epoch
    t_comm: np.ndarray    # (N,) seconds for model down+up
    e_comp: np.ndarray    # (N,) joules per local epoch
    e_comm: np.ndarray    # (N,) joules for comms
    load: np.ndarray      # (N,) current interference multiplier (<=1)


_TIERS = [
    # (effective training FLOP/s, bw B/s, J/FLOP, J/byte)
    (1.2e9, 12.5e6, 4.0e-9, 1.5e-7),     # flagship
    (3.5e8, 5.0e6, 1.0e-8, 3.0e-7),      # mid-range
    (6.0e7, 1.5e6, 2.5e-8, 6.0e-7),      # low-end
]

# fixed per-round protocol overhead (handshake, scheduling), seconds
_COMM_OVERHEAD_S = 2.0


class DevicePool:
    """N simulated devices with static + dynamic heterogeneity.

    ``speed``, ``bandwidth``, ``j_per_flop``, ``j_per_byte`` and ``tier`` are
    ``(N,)`` vectors sampled once at construction; dynamics are delegated to
    the scenario models.  ``DevicePool(n, seed)`` with no models is the
    ``uniform`` scenario (Markov load, always available, no failures).

    ``region`` holds static region labels (``regions=``, contiguous blocks
    in a regioned scenario; a flat fleet is one region, label 0) named by
    ``region_names``; ``tier_probs`` may then be one row per region.
    ``tiers`` replaces the tier table, and ``attack`` is the scenario's
    :class:`~repro_torch.fl.attacks.AttackModel` (held, not consumed: the
    engines resolve it and draw from its own RNG stream, never ``rng``).
    """

    def __init__(self, n_devices: int, seed: int = 0,
                 tier_probs: Optional[List[float]] = None, *,
                 tiers: Optional[Sequence[Sequence[float]]] = None,
                 load_model=None, availability=None, failures=None,
                 attack=None,
                 regions: Optional[np.ndarray] = None,
                 region_names: Optional[Sequence[str]] = None):
        from repro_torch.fl.scenarios import (   # deferred: scenarios imports us
            AlwaysAvailable,
            FailureModel,
            MarkovLoad,
        )

        self.n = n_devices
        self.rng = np.random.default_rng(seed)
        if regions is None:
            self.region = np.zeros(n_devices, dtype=np.int64)
        else:
            self.region = np.asarray(regions, dtype=np.int64)
            if len(self.region) != n_devices:
                raise ValueError(f"regions has {len(self.region)} labels for "
                                 f"{n_devices} devices")
        self.n_regions = int(self.region.max()) + 1 if n_devices else 1
        self.region_names = (list(region_names) if region_names is not None
                             else [f"region{i}" for i in range(self.n_regions)])
        if len(self.region_names) != self.n_regions:
            raise ValueError(f"{len(self.region_names)} region names for "
                             f"{self.n_regions} region labels")
        tier_probs = np.asarray(tier_probs if tier_probs is not None
                                else [0.25, 0.5, 0.25], dtype=np.float64)
        tier_table = np.asarray(tiers if tiers is not None else _TIERS,
                                dtype=np.float64)
        # one inverse-CDF draw for tiers, one (4, N) block for the jitters
        u = self.rng.random(n_devices)
        if tier_probs.ndim == 2:
            # one tier mix per region: the same draw, each device's inverse
            # CDF gathered from its region's row
            if len(tier_probs) != self.n_regions:
                raise ValueError(f"tier_probs has {len(tier_probs)} rows for "
                                 f"{self.n_regions} regions")
            cdf = np.cumsum(tier_probs, axis=1) / tier_probs.sum(axis=1,
                                                                 keepdims=True)
            self.tier = np.minimum((u[:, None] > cdf[self.region]).sum(axis=1),
                                   len(tier_table) - 1)
        else:
            cdf = np.cumsum(tier_probs) / tier_probs.sum()
            self.tier = np.minimum(np.searchsorted(cdf, u), len(tier_table) - 1)
        base = tier_table[self.tier]                        # (N, 4)
        jit = np.exp(0.25 * self.rng.standard_normal((4, n_devices)))
        self.speed = base[:, 0] * jit[0]
        self.bandwidth = base[:, 1] * jit[1]
        self.j_per_flop = base[:, 2] * jit[2]
        self.j_per_byte = base[:, 3] * jit[3]

        self.load_model = load_model if load_model is not None else MarkovLoad()
        self.availability = (availability if availability is not None
                             else AlwaysAvailable())
        self.failures = failures if failures is not None else FailureModel()
        self.attack = attack
        self._load_state = self.load_model.init_state(n_devices, self.rng)
        self._avail_state = self.availability.init_state(n_devices, self.rng)
        self.round_idx = 0
        self._profiles: Optional[List[DeviceProfile]] = None
        self._comm_cache = None   # (model_bytes, t_comm, e_comm)
        self._inv_speed = 1.0 / self.speed

    @property
    def devices(self) -> List[DeviceProfile]:
        """Per-device profile objects (a view over the arrays, built once)."""
        if self._profiles is None:
            self._profiles = [
                DeviceProfile(float(self.speed[i]), float(self.bandwidth[i]),
                              float(self.j_per_flop[i]), float(self.j_per_byte[i]),
                              int(self.tier[i]))
                for i in range(self.n)]
        return self._profiles

    def advance_round(self) -> None:
        """Step every device's load + availability dynamics."""
        self.round_idx += 1
        self._load_state = self.load_model.step(self._load_state, self.rng,
                                                self.round_idx)
        self._avail_state = self.availability.step(self._avail_state, self.rng,
                                                   self.round_idx)

    def advance_to(self, round_idx: int) -> None:
        """Fast-forward the dynamics to ``round_idx``.  Stochastic models
        replay every intermediate step, keeping their per-round RNG draws;
        when load and availability both declare ``stateless_replay`` (trace
        replay, the deterministic diurnal/always patterns) the jump is one
        assignment.  The async engine calls this at availability
        transitions (:meth:`next_transition`)."""
        if (getattr(self.load_model, "stateless_replay", False)
                and getattr(self.availability, "stateless_replay", False)):
            self.round_idx = max(self.round_idx, round_idx)
            return
        while self.round_idx < round_idx:
            self.advance_round()

    def next_transition(self) -> Optional[int]:
        """Next round index at which the availability mask may change
        (``None`` = never).  Models without ``next_transition`` are taken
        to be able to flip every round."""
        fn = getattr(self.availability, "next_transition", None)
        if fn is None:
            return self.round_idx + 1
        return fn(self._avail_state, self.round_idx)

    def loads(self) -> np.ndarray:
        return self.load_model.loads(self._load_state, self.round_idx)

    def available(self) -> np.ndarray:
        """(N,) bool online mask for the current round, with at least one
        device online (an empty round would stall every round loop)."""
        mask = np.asarray(self.availability.mask(self._avail_state,
                                                 self.round_idx), dtype=bool)
        if not mask.any():
            mask = mask.copy()
            mask[int(self.rng.integers(self.n))] = True
        return mask

    def region_ids(self, region: int) -> np.ndarray:
        """Device ids carrying the given region label."""
        return np.flatnonzero(self.region == region)

    def draw_failures(self, rng: np.random.Generator, selected: np.ndarray,
                      completion_s: np.ndarray):
        """Delegate mid-round failures to the scenario's failure model."""
        return self.failures.draw(rng, selected, completion_s)

    def system_state(self, flops_per_epoch: np.ndarray, model_bytes: float
                     ) -> RoundSystemState:
        """flops_per_epoch: (N,) — depends on each client's local data size."""
        load = self.loads()
        t_comp = flops_per_epoch * self._inv_speed / load
        if self._comm_cache is None or self._comm_cache[0] != model_bytes:
            self._comm_cache = (
                model_bytes,
                2.0 * model_bytes / self.bandwidth + _COMM_OVERHEAD_S,
                2.0 * model_bytes * self.j_per_byte)
        _, t_comm, e_comm = self._comm_cache
        e_comp = flops_per_epoch * self.j_per_flop
        return RoundSystemState(t_comp, t_comm, e_comp, e_comm, load)


def static_estimates(pool: DevicePool, flops_per_epoch: np.ndarray,
                     model_bytes: float, l_ep: int):
    """Load-free per-device full-round latency/energy estimates — what a
    scheduler knows *before* probing."""
    t = (2 * model_bytes / pool.bandwidth + _COMM_OVERHEAD_S
         + l_ep * flops_per_epoch / pool.speed)
    e = 2 * model_bytes * pool.j_per_byte + l_ep * flops_per_epoch * pool.j_per_flop
    return t, e


def plan_round_latency(state: RoundSystemState, probe_ids: np.ndarray,
                       selected: np.ndarray, probe_epochs: int,
                       completion_epochs: int,
                       deadline_s: Optional[float] = None) -> float:
    """R_T for a RoundPlan: the probe barrier (max over the probe cohort of
    ``probe_epochs`` compute epochs) plus the completion stage (max over the
    selected of comms + ``completion_epochs`` epochs), stragglers cut at the
    deadline."""
    t = (float(state.t_comp[probe_ids].max()) * probe_epochs
         if len(probe_ids) and probe_epochs else 0.0)
    if len(selected) == 0:
        return t
    rest = state.t_comm[selected] + state.t_comp[selected] * completion_epochs
    if deadline_s is not None:
        rest = np.minimum(rest, deadline_s)
    return t + float(rest.max())


def plan_round_energy(state: RoundSystemState, probe_ids: np.ndarray,
                      selected: np.ndarray, probe_epochs: int,
                      completion_epochs: int,
                      deadline_s: Optional[float] = None) -> float:
    """R_E for a RoundPlan: probe compute summed over the whole probe cohort,
    plus comms + completion compute summed over the selected; a straggler is
    charged pro-rata up to the deadline."""
    e = (float(state.e_comp[probe_ids].sum()) * probe_epochs
         if len(probe_ids) and probe_epochs else 0.0)
    if len(selected) == 0:
        return e
    rest = state.e_comm[selected] + state.e_comp[selected] * completion_epochs
    if deadline_s is not None:
        t_full = state.t_comm[selected] + state.t_comp[selected] * completion_epochs
        frac = np.clip(deadline_s / np.maximum(t_full, 1e-12), 0.0, 1.0)
        rest = rest * frac
    return e + float(rest.sum())


def client_job_latency(state: RoundSystemState, ids: np.ndarray, epochs: int,
                       include_comm: bool = True) -> np.ndarray:
    """(len(ids),) seconds of active work for one client job: ``epochs``
    local epochs plus (optionally) the model down+up transfer; the
    asynchronous engine overlaps these on its virtual clock."""
    t = state.t_comp[ids] * epochs
    if include_comm:
        t = t + state.t_comm[ids]
    return t


def client_job_energy(state: RoundSystemState, ids: np.ndarray, epochs: int,
                      include_comm: bool = True) -> np.ndarray:
    """(len(ids),) joules for one client job (see :func:`client_job_latency`)."""
    e = state.e_comp[ids] * epochs
    if include_comm:
        e = e + state.e_comm[ids]
    return e


def round_latency(state: RoundSystemState, probe_set: np.ndarray,
                  selected: np.ndarray, l_ep: int) -> float:
    """R_T per the paper: T_prob + max over selected of
    (T_comm + T_comp * (l_ep - 1))."""
    return plan_round_latency(state, probe_set, selected, 1, l_ep - 1)


def round_energy(state: RoundSystemState, probe_set: np.ndarray,
                 selected: np.ndarray, l_ep: int) -> float:
    """R_E per the paper: E_prob + sum over selected of
    (E_comm + E_comp * (l_ep - 1))."""
    return plan_round_energy(state, probe_set, selected, 1, l_ep - 1)


def vanilla_round_latency(state: RoundSystemState, selected: np.ndarray,
                          l_ep: int) -> float:
    """Non-probing baseline: every selected device runs all l_ep epochs."""
    return plan_round_latency(state, np.empty(0, np.int64), selected, 0, l_ep)


def vanilla_round_energy(state: RoundSystemState, selected: np.ndarray,
                         l_ep: int) -> float:
    """Energy of the non-probing baseline (see :func:`vanilla_round_latency`)."""
    return plan_round_energy(state, np.empty(0, np.int64), selected, 0, l_ep)
