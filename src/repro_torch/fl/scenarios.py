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

``ScenarioSpec.regions`` adds a hierarchical axis: the fleet is apportioned
over named :class:`RegionSpec` leaves (contiguous label blocks,
:func:`split_by_weight`), each optionally overriding the tier mix, load,
availability or trace of its slice (:class:`RegionalLoad`,
:class:`RegionalAvailability`); :class:`RegionOutage` darkens whole regions
at once.  ``ScenarioSpec.attack`` carries an
:class:`~repro_torch.fl.attacks.AttackModel`.

Registered: ``uniform``, ``cellular-tail``, ``nightly-chargers``,
``flash-crowd``, ``high-churn``, ``trace-livelab``, ``trace-synthetic-week``,
``hierarchical``, ``regional-outage``, ``stragglers``,
``byzantine-signflip``, ``byzantine-scaled`` and ``label-drift``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.fl import attacks as _atk
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


@dataclass(frozen=True)
class RegionOutage:
    """Correlated regional outages over any per-device availability model.

    Wraps ``inner`` and overlays region-wide offline windows: each round
    every region that is up goes dark with probability ``outage_prob`` for
    ``outage_len`` rounds (the whole region at once).  Region extents are
    bound at :meth:`ScenarioSpec.build` (:meth:`bind_regions`; label blocks
    are contiguous in region order).  The inner model keeps stepping through
    an outage, so a region comes back where its devices' own dynamics are.
    """

    inner: Any = field(default_factory=AlwaysAvailable)
    outage_prob: float = 0.05
    outage_len: int = 3
    region_sizes: Tuple[int, ...] = ()     # bound by ScenarioSpec.build

    def bind_regions(self, sizes) -> "RegionOutage":
        return dataclasses.replace(self, region_sizes=tuple(int(s) for s in sizes))

    def _sizes(self, n: int) -> Tuple[int, ...]:
        # unbound (no regions declared): the whole fleet is one region
        return self.region_sizes if self.region_sizes else (n,)

    def init_state(self, n: int, rng: np.random.Generator):
        inner_state = self.inner.init_state(n, rng)
        remaining = np.zeros(len(self._sizes(n)), dtype=np.int64)
        return (inner_state, remaining, n)

    def step(self, state, rng: np.random.Generator, round_idx: int):
        inner_state, remaining, n = state
        inner_state = self.inner.step(inner_state, rng, round_idx)
        remaining = np.maximum(remaining - 1, 0)
        start = rng.random(len(remaining)) < self.outage_prob
        remaining = np.where((remaining == 0) & start, self.outage_len, remaining)
        return (inner_state, remaining, n)

    def mask(self, state, round_idx: int) -> np.ndarray:
        inner_state, remaining, n = state
        m = np.asarray(self.inner.mask(inner_state, round_idx), dtype=bool).copy()
        m[np.repeat(remaining > 0, self._sizes(n))] = False
        return m

    def next_transition(self, state, round_idx: int) -> Optional[int]:
        # outage starts are Bernoulli per round: the mask may change every step
        return round_idx + 1


@dataclass(frozen=True)
class RegionalLoad:
    """Composite load model: each region runs its own sub-model over its
    contiguous device slice (states initialized and stepped in region order
    from the pool's one RNG)."""

    models: Tuple[Any, ...]
    sizes: Tuple[int, ...]

    def init_state(self, n: int, rng: np.random.Generator):
        if n != sum(self.sizes):
            raise ValueError(f"regional sizes {self.sizes} sum to "
                             f"{sum(self.sizes)}, fleet has {n}")
        return tuple(m.init_state(s, rng) for m, s in zip(self.models, self.sizes))

    def step(self, state, rng: np.random.Generator, round_idx: int):
        return tuple(m.step(st, rng, round_idx)
                     for m, st in zip(self.models, state))

    def loads(self, state, round_idx: int) -> np.ndarray:
        return np.concatenate([np.asarray(m.loads(st, round_idx))
                               for m, st in zip(self.models, state)])


@dataclass(frozen=True)
class RegionalAvailability:
    """Composite availability model: per-region sub-models over contiguous
    slices; ``next_transition`` is the earliest of the regions'."""

    models: Tuple[Any, ...]
    sizes: Tuple[int, ...]

    def init_state(self, n: int, rng: np.random.Generator):
        if n != sum(self.sizes):
            raise ValueError(f"regional sizes {self.sizes} sum to "
                             f"{sum(self.sizes)}, fleet has {n}")
        return tuple(m.init_state(s, rng) for m, s in zip(self.models, self.sizes))

    def step(self, state, rng: np.random.Generator, round_idx: int):
        return tuple(m.step(st, rng, round_idx)
                     for m, st in zip(self.models, state))

    def mask(self, state, round_idx: int) -> np.ndarray:
        return np.concatenate([np.asarray(m.mask(st, round_idx), dtype=bool)
                               for m, st in zip(self.models, state)])

    def next_transition(self, state, round_idx: int) -> Optional[int]:
        nxt = None
        for m, st in zip(self.models, state):
            fn = getattr(m, "next_transition", None)
            t = fn(st, round_idx) if fn is not None else round_idx + 1
            if t is not None:
                nxt = t if nxt is None else min(nxt, t)
        return nxt


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
class RegionSpec:
    """One leaf region of a hierarchical fleet (``ScenarioSpec.regions``).

    ``weight`` apportions the fleet (:func:`split_by_weight`); any of
    ``tier_probs`` / ``load`` / ``availability`` / ``trace`` overrides the
    spec-level default for this region's slice; ``budget`` is an optional
    per-region selection budget ``k_r`` (:mod:`repro_torch.fl.topology`)."""

    name: str
    weight: float = 1.0
    tier_probs: Optional[Tuple[float, ...]] = None
    load: Any = None
    availability: Any = None
    trace: Optional[TraceSpec] = None
    budget: Optional[int] = None


def split_by_weight(n: int, weights) -> List[int]:
    """Largest-remainder apportionment of ``n`` devices over regions
    (deterministic; every region gets at least 1 device)."""
    w = np.asarray(weights, dtype=np.float64)
    if len(w) > n:
        raise ValueError(f"{len(w)} regions need at least {len(w)} devices, "
                         f"got {n}")
    quota = w / w.sum() * (n - len(w))      # reserve 1 per region up front
    counts = np.floor(quota).astype(np.int64) + 1
    rem = n - int(counts.sum())
    # remainders to the largest fractional parts (ties: region order)
    order = np.argsort(-(quota - np.floor(quota)), kind="stable")
    counts[order[:rem]] += 1
    return [int(c) for c in counts]


@dataclass(frozen=True)
class ScenarioSpec:
    """A fleet environment: tier mix x load dynamics x availability x
    failures, optionally regions and an attack.  Build the runtime fleet
    with :meth:`build`."""

    name: str
    description: str = ""
    tier_probs: Tuple[float, ...] = (0.25, 0.5, 0.25)
    tiers: Optional[Tuple[Tuple[float, float, float, float], ...]] = None
    load: Any = field(default_factory=MarkovLoad)
    availability: Any = field(default_factory=AlwaysAvailable)
    failures: FailureModel = field(default_factory=FailureModel)
    trace: Optional[TraceSpec] = None     # replaces load+availability with a
    #                                       coherent replayed device trace
    regions: Optional[Tuple[RegionSpec, ...]] = None
    attack: Any = None                    # AttackModel corrupting adversarial
    #                                       uploads; None = every client honest

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
        pool_kw = {}
        tier_probs = list(self.tier_probs)
        counts = [n_devices]
        if self.regions:
            counts = split_by_weight(n_devices, [r.weight for r in self.regions])
            pool_kw["regions"] = np.repeat(np.arange(len(counts)), counts)
            pool_kw["region_names"] = [r.name for r in self.regions]
            if any(r.tier_probs is not None for r in self.regions):
                tier_probs = [list(r.tier_probs if r.tier_probs is not None
                                   else self.tier_probs) for r in self.regions]
            models = [self._region_models(r, i, counts[i], seed, device)
                      for i, r in enumerate(self.regions)]
            if any(r.load is not None or r.trace is not None for r in self.regions):
                load = RegionalLoad(tuple(m[0] for m in models), tuple(counts))
            if any(r.availability is not None or r.trace is not None
                   for r in self.regions):
                availability = RegionalAvailability(tuple(m[1] for m in models),
                                                    tuple(counts))
        if hasattr(availability, "bind_regions"):
            # region-correlated models (RegionOutage) learn the label blocks'
            # extents; an unregioned spec is one region
            availability = availability.bind_regions(counts)
        return DevicePool(n_devices, seed=seed, tier_probs=tier_probs,
                          tiers=self.tiers, load_model=load,
                          availability=availability, failures=self.failures,
                          attack=self.attack, **pool_kw)

    def _region_models(self, region: RegionSpec, idx: int, count: int,
                       seed: int, device: DeviceLike):
        """(load, availability) for one region slice; a region-level trace
        replaces both with a replay resolved per region (its own resample
        seed per region index)."""
        if region.trace is not None:
            return region.trace.resolve(count, seed=seed + 7919 * (idx + 1),
                                        device=device)
        return (region.load if region.load is not None else self.load,
                region.availability if region.availability is not None
                else self.availability)


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
    name="hierarchical",
    description="3-region edge hierarchy: a flagship-heavy metro core with "
                "mild churn, a balanced suburban ring on nightly charging "
                "windows, and a low-end rural edge with aggressive churn — "
                "the per-region tier/availability contrast hierarchical "
                "selection budgets (repro_torch.fl.topology) are about.",
    regions=(
        RegionSpec(name="metro", weight=0.3, tier_probs=(0.5, 0.4, 0.1),
                   availability=ChurnAvailability(p_drop=0.05, p_join=0.6,
                                                  init_online=0.95)),
        RegionSpec(name="suburban", weight=0.4,
                   availability=DiurnalAvailability(duty=0.5)),
        RegionSpec(name="rural", weight=0.3, tier_probs=(0.05, 0.25, 0.7),
                   availability=ChurnAvailability(p_drop=0.3, p_join=0.3,
                                                  init_online=0.7)),
    ),
    failures=FailureModel(dropout=0.05),
))

register_scenario(ScenarioSpec(
    name="regional-outage",
    description="Correlated regional failures: three equal regions of "
                "churning devices, each going entirely dark for a few "
                "rounds at a time (RegionOutage over ChurnAvailability) — "
                "a backbone cut no per-device churn model can express.",
    regions=(
        RegionSpec(name="east", weight=1.0),
        RegionSpec(name="central", weight=1.0),
        RegionSpec(name="west", weight=1.0),
    ),
    availability=RegionOutage(
        inner=ChurnAvailability(p_drop=0.1, p_join=0.5, init_online=0.9),
        outage_prob=0.08, outage_len=3),
    failures=FailureModel(dropout=0.05),
))

register_scenario(ScenarioSpec(
    name="stragglers",
    description="Deadline-dominated: low-end-heavy mix under a tight "
                "1.5x-median deadline — slow devices burn energy up to the "
                "timeout and upload nothing.",
    tier_probs=(0.15, 0.35, 0.50),
    failures=FailureModel(deadline_factor=1.5),
))

register_scenario(ScenarioSpec(
    name="byzantine-signflip",
    description="30% of the fleet is Byzantine: compromised devices upload "
                "boosted sign-flipped updates (g - 4*(p - g)), enough to "
                "stall or reverse a plain mean — the canonical stress test "
                "for trimmed-mean/Krum aggregation (FLConfig.aggregator).",
    attack=_atk.SignFlip(fraction=0.3, scale=4.0),
))

register_scenario(ScenarioSpec(
    name="byzantine-scaled",
    description="20% model-replacement boosters: adversaries upload their "
                "honest delta scaled 10x (backdoor-style amplification) "
                "under mild churn — magnitude poisoning that norm-blind "
                "averaging absorbs and coordinate-wise defenses clip.",
    availability=ChurnAvailability(p_drop=0.1, p_join=0.5, init_online=0.9),
    attack=_atk.ScaledUpdate(fraction=0.2, factor=10.0),
))

register_scenario(ScenarioSpec(
    name="label-drift",
    description="Drifting label skew: 30% of devices behave as if their "
                "label distribution rotates one class every 2 rounds — "
                "their classifier-head updates are rolled along the label "
                "axis on the round clock, a moving pathology no static "
                "robust mean can memorize.",
    attack=_atk.LabelSkewDrift(fraction=0.3, period=2),
))
