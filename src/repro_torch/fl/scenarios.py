"""Fleet scenarios: composable device-fleet environments (numpy, host side).

A :class:`ScenarioSpec` composes a tier mix, load dynamics
(:class:`MarkovLoad`, :class:`DiurnalLoad`, :class:`FlashCrowdLoad`), an
availability model (:class:`AlwaysAvailable`, :class:`ChurnAvailability`,
:class:`DiurnalAvailability`) and a :class:`FailureModel` (dropout + deadline
stragglers).  Every model draws from the pool's RNG in the reference's order,
so a scenario replays the reference's fleet exactly.

A scenario may instead carry a :class:`~repro_torch.fl.traces.TraceSpec`
(``ScenarioSpec.trace``): a replayed device trace supplies load and
availability from one timeline, and its segment lookups run on the device
the fleet is built for (``build(..., device=)``; the ``fleet_state`` kernel
on the card).

Availability models tell the asynchronous engine when their mask can next
change (``next_transition``) and whether rounds can be skipped without
stepping (``stateless_replay``), as in the reference.

This package registers the scenarios without regions or attacks:
``uniform``, ``cellular-tail``, ``nightly-chargers``, ``flash-crowd``,
``high-churn``, ``trace-livelab``, ``trace-synthetic-week`` and
``stragglers``.  Any other name raises ``KeyError``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.fl.traces import SyntheticTraceSpec, TraceSpec, sample_trace_path


# ---------------------------------------------------------------------------
# Load dynamics models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MarkovLoad:
    """Per-device Markov chain over interference levels (the seed model)."""

    levels: Tuple[float, ...] = (1.0, 0.55, 0.25)
    trans: Tuple[Tuple[float, ...], ...] = (
        (0.80, 0.15, 0.05),
        (0.30, 0.55, 0.15),
        (0.15, 0.35, 0.50),
    )

    def init_state(self, n: int, rng: np.random.Generator):
        return rng.integers(0, len(self.levels), size=n)

    def step(self, state, rng: np.random.Generator, round_idx: int):
        # inverse-CDF per state via (N,) gathers, float32 uniforms
        cdf = np.cumsum(np.asarray(self.trans, dtype=np.float32), axis=1)
        u = rng.random(len(state), dtype=np.float32)
        new = (u > cdf[:, 0][state]).astype(np.int8)
        for j in range(1, len(self.levels) - 1):
            new += u > cdf[:, j][state]
        return new.astype(state.dtype, copy=False)

    def loads(self, state, round_idx: int) -> np.ndarray:
        return np.asarray(self.levels)[state]


@dataclass(frozen=True)
class DiurnalLoad:
    """Per-device phase-shifted diurnal interference (busy at the local
    daytime peak) with a small per-round lognormal wobble."""

    period: int = 24          # rounds per simulated day
    idle_load: float = 1.0    # multiplier when the device is unused
    busy_load: float = 0.3    # multiplier at peak usage
    phase_spread: float = 0.25  # stddev of per-device peak offset (days)
    jitter: float = 0.1       # per-round lognormal sigma

    def init_state(self, n: int, rng: np.random.Generator):
        phase = rng.normal(0.0, self.phase_spread, size=n)
        noise = rng.lognormal(0.0, self.jitter, size=n)
        return (phase, noise)

    def step(self, state, rng: np.random.Generator, round_idx: int):
        phase, _ = state
        return (phase, rng.lognormal(0.0, self.jitter, size=len(phase)))

    def loads(self, state, round_idx: int) -> np.ndarray:
        phase, noise = state
        usage = 0.5 * (1.0 + np.cos(2 * np.pi * (round_idx / self.period + phase)))
        base = self.idle_load - (self.idle_load - self.busy_load) * usage
        return np.clip(base * noise, 0.05, 1.0)


@dataclass(frozen=True)
class FlashCrowdLoad:
    """Correlated usage spikes: with probability ``spike_prob`` per round a
    random ``spike_frac`` of the fleet drops to ``spike_load`` for
    ``spike_len`` rounds."""

    base_jitter: float = 0.15
    spike_prob: float = 0.15
    spike_frac: float = 0.6
    spike_load: float = 0.15
    spike_len: int = 3

    def init_state(self, n: int, rng: np.random.Generator):
        noise = rng.lognormal(0.0, self.base_jitter, size=n)
        affected = np.zeros(n, bool)
        return (0, affected, noise)          # (rounds remaining, mask, wobble)

    def step(self, state, rng: np.random.Generator, round_idx: int):
        remaining, affected, _ = state
        n = len(affected)
        noise = rng.lognormal(0.0, self.base_jitter, size=n)
        if remaining > 0:
            return (remaining - 1, affected, noise)
        if rng.random() < self.spike_prob:
            affected = rng.random(n) < self.spike_frac
            return (self.spike_len, affected, noise)
        return (0, np.zeros(n, bool), noise)

    def loads(self, state, round_idx: int) -> np.ndarray:
        remaining, affected, noise = state
        base = np.where(remaining > 0, np.where(affected, self.spike_load, 1.0),
                        1.0)
        return np.clip(base * noise, 0.05, 1.0)


# ---------------------------------------------------------------------------
# Availability models
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlwaysAvailable:
    """Every device is online every round."""

    # pure function of round_idx: DevicePool.advance_to may jump rounds
    stateless_replay = True

    def init_state(self, n: int, rng: np.random.Generator):
        return np.ones(n, bool)

    def step(self, state, rng: np.random.Generator, round_idx: int):
        return state

    def mask(self, state, round_idx: int) -> np.ndarray:
        return state

    def next_transition(self, state, round_idx: int) -> Optional[int]:
        return None                      # the mask never changes


@dataclass(frozen=True)
class ChurnAvailability:
    """2-state per-device Markov churn: online devices drop with ``p_drop``
    per round, offline devices rejoin with ``p_join``."""

    p_drop: float = 0.2
    p_join: float = 0.4
    init_online: float = 0.8

    def init_state(self, n: int, rng: np.random.Generator):
        return rng.random(n) < self.init_online

    def step(self, state, rng: np.random.Generator, round_idx: int):
        u = rng.random(len(state))
        return np.where(state, u >= self.p_drop, u < self.p_join)

    def mask(self, state, round_idx: int) -> np.ndarray:
        return state

    def next_transition(self, state, round_idx: int) -> Optional[int]:
        # stochastic churn: the mask may flip on every step
        return round_idx + 1


@dataclass(frozen=True)
class DiurnalAvailability:
    """"Nightly chargers": each device is eligible only during its charging
    window, a ``duty`` fraction of the day, phase-shifted per device."""

    period: int = 24
    duty: float = 0.4
    phase_spread: float = 0.15   # most users charge at a similar local hour

    # step() keeps state verbatim and draws no RNG: replay can jump rounds
    stateless_replay = True

    def init_state(self, n: int, rng: np.random.Generator):
        return rng.normal(0.0, self.phase_spread, size=n) % 1.0

    def step(self, state, rng: np.random.Generator, round_idx: int):
        return state

    def mask(self, state, round_idx: int) -> np.ndarray:
        t = (round_idx / self.period + state) % 1.0
        return t < self.duty

    def next_transition(self, state, round_idx: int) -> Optional[int]:
        """Exact next round at which any device enters or leaves its
        charging window (the mask is ``period``-periodic, so a full period
        with no change means it never changes)."""
        cur = self.mask(state, round_idx)
        for r in range(round_idx + 1, round_idx + self.period + 1):
            if not np.array_equal(self.mask(state, r), cur):
                return r
        return None


# ---------------------------------------------------------------------------
# Failure model (applies to *selected* devices mid-round)
# ---------------------------------------------------------------------------


@dataclass
class FailureOutcome:
    """Who dropped and who timed out among the selected cohort."""

    failed: np.ndarray          # int64 ids: dropped before upload, full cost sunk
    stragglers: np.ndarray      # int64 ids: hit the deadline, cost capped at it
    deadline_s: Optional[float]  # resolved round deadline (None = no deadline)

    @property
    def lost(self) -> np.ndarray:
        """All selected devices that contribute no update."""
        return np.concatenate([self.failed, self.stragglers])


@dataclass(frozen=True)
class FailureModel:
    """Bernoulli dropout + deadline-based straggler timeout.

    ``dropout`` — per-round probability a selected device vanishes before
    uploading; its full round cost is sunk.  ``deadline_s`` /
    ``deadline_factor`` — absolute seconds, or a multiple of the selected
    cohort's median completion time; a device past it is charged up to the
    timeout and uploads nothing.
    """

    dropout: float = 0.0
    deadline_s: Optional[float] = None
    deadline_factor: Optional[float] = None

    def resolve_deadline(self, completion_s: np.ndarray) -> Optional[float]:
        if self.deadline_s is not None:
            return float(self.deadline_s)
        if self.deadline_factor is not None and len(completion_s):
            return float(self.deadline_factor * np.median(completion_s))
        return None

    def draw(self, rng: np.random.Generator, selected: np.ndarray,
             completion_s: np.ndarray) -> FailureOutcome:
        """selected: (K,) ids; completion_s: (K,) per-device completion-stage
        seconds (comms + completion epochs)."""
        selected = np.asarray(selected, dtype=np.int64)
        drop = (rng.random(len(selected)) < self.dropout if self.dropout > 0
                else np.zeros(len(selected), bool))
        deadline = self.resolve_deadline(completion_s)
        if deadline is not None:
            late = (np.asarray(completion_s) > deadline) & ~drop
        else:
            late = np.zeros(len(selected), bool)
        return FailureOutcome(failed=selected[drop], stragglers=selected[late],
                              deadline_s=deadline)


# ---------------------------------------------------------------------------
# ScenarioSpec + registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScenarioSpec:
    """A fleet environment: tier mix x load dynamics x availability x
    failures.  Build the runtime fleet with :meth:`build`."""

    name: str
    description: str = ""
    tier_probs: Tuple[float, ...] = (0.25, 0.5, 0.25)
    load: Any = field(default_factory=MarkovLoad)
    availability: Any = field(default_factory=AlwaysAvailable)
    failures: FailureModel = field(default_factory=FailureModel)
    trace: Optional[TraceSpec] = None     # replaces load+availability with a
    #                                       coherent replayed device trace

    def build(self, n_devices: int, seed: int = 0, device: DeviceLike = None):
        """The runtime fleet.  ``device`` is where a trace's segment lookups
        run (the card unless ``"cpu"``); scenarios without a trace ignore
        it."""
        from repro_torch.fl.simulation import DevicePool

        load, availability = self.load, self.availability
        if self.trace is not None:
            # one resolve => load and availability replay the SAME
            # bootstrapped fleet (deterministic in (spec, n_devices, seed))
            load, availability = self.trace.resolve(n_devices, seed=seed,
                                                    device=device)
        return DevicePool(n_devices, seed=seed, tier_probs=list(self.tier_probs),
                          load_model=load, availability=availability,
                          failures=self.failures)


_SCENARIOS: Dict[str, ScenarioSpec] = {}


def register_scenario(spec: ScenarioSpec) -> ScenarioSpec:
    """Register a named scenario (duplicate names are an error)."""
    if spec.name in _SCENARIOS:
        raise ValueError(f"scenario {spec.name!r} already registered")
    _SCENARIOS[spec.name] = spec
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    try:
        return _SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {available_scenarios()}") from None


def build_scenario(name: str, n_devices: int, seed: int = 0,
                   device: DeviceLike = None, **overrides):
    """Build the named scenario's fleet (trace lookups on ``device``);
    ``overrides`` replace spec fields (e.g. ``trace=TraceSpec(csv=...)``)."""
    spec = get_scenario(name)
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    return spec.build(n_devices, seed=seed, device=device)


def available_scenarios() -> List[str]:
    return sorted(_SCENARIOS)


# ---------------------------------------------------------------------------
# Built-in scenarios
# ---------------------------------------------------------------------------

register_scenario(ScenarioSpec(
    name="uniform",
    description="Seed environment: balanced tier mix, Markov interference, "
                "every device always online, no failures.",
))

register_scenario(ScenarioSpec(
    name="cellular-tail",
    description="Emerging-market fleet: low-end-heavy tier mix on congested "
                "cellular links; mild dropout and a 3x-median round deadline "
                "cut off the latency tail.",
    tier_probs=(0.10, 0.30, 0.60),
    failures=FailureModel(dropout=0.05, deadline_factor=3.0),
))

register_scenario(ScenarioSpec(
    name="nightly-chargers",
    description="Devices are eligible only in their nightly charging window "
                "(duty cycle ~40%); charging devices are otherwise idle, so "
                "interference is light but diurnal.",
    load=DiurnalLoad(busy_load=0.5, jitter=0.1),
    availability=DiurnalAvailability(duty=0.4),
))

register_scenario(ScenarioSpec(
    name="flash-crowd",
    description="Correlated usage spikes: flash-crowd events periodically "
                "drag 60% of the fleet to 15% effective compute for a few "
                "rounds; spiking devices also drop out occasionally.",
    load=FlashCrowdLoad(),
    failures=FailureModel(dropout=0.05),
))

register_scenario(ScenarioSpec(
    name="high-churn",
    description="Aggressive availability churn (20% drop / 40% rejoin per "
                "round) with 10% mid-round dropout — selection must hedge "
                "against who will still be there at upload time.",
    availability=ChurnAvailability(p_drop=0.2, p_join=0.4),
    failures=FailureModel(dropout=0.1),
))

register_scenario(ScenarioSpec(
    name="trace-livelab",
    description="Replays the shipped LiveLab-format sample trace (8 source "
                "devices over 3 days, bootstrapped to the fleet size): "
                "coherent per-device usage/charging/offline timelines with "
                "mild mid-round dropout.  Swap in your own trace via "
                "FLConfig.trace_csv.",
    trace=TraceSpec(csv=sample_trace_path()),
    failures=FailureModel(dropout=0.05),
))

register_scenario(ScenarioSpec(
    name="trace-synthetic-week",
    description="A synthetic week of realistic device behavior (nightly "
                "charging, daytime sessions, weekend shift, offline spells) "
                "from the deterministic generator — the trace analogue of "
                "nightly-chargers, reproducible with no data files.",
    trace=TraceSpec(synthetic=SyntheticTraceSpec(n_devices=32, days=7,
                                                 seed=11)),
))

register_scenario(ScenarioSpec(
    name="stragglers",
    description="Deadline-dominated: low-end-heavy mix under a tight "
                "1.5x-median deadline — slow devices burn energy up to the "
                "timeout and upload nothing.",
    tier_probs=(0.15, 0.35, 0.50),
    failures=FailureModel(deadline_factor=1.5),
))
