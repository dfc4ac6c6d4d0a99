"""Trace-backed scenario models: replay a compiled trace as load/availability.

:class:`TraceLoad` and :class:`TraceAvailability` implement the scenario
load/availability protocols (``init_state`` / ``step`` / ``loads`` | ``mask``
— see :mod:`repro_torch.fl.scenarios`) over one shared
:class:`~repro_torch.fl.traces.trace.ResampledFleet`, so a fleet device's
interference and its reachability come from the same source-device timeline.

Replay is a pure function of ``(trace, n, seed, round_idx)``: the models draw
no RNG, so trace scenarios are deterministic across engines and runs, and the
async engine's lazy replay (:meth:`~repro_torch.fl.simulation.DevicePool.advance_to`)
is a jump.  Round ``r`` reads the trace at ``r * seconds_per_round`` (per
device, plus its resample phase).  ``TraceAvailability.next_transition`` is
exact: the first future round whose sampled mask differs, which is what lets
the async engine's virtual clock jump between trace events.  Every lookup is
a segment lookup on the fleet's device (the ``fleet_state`` kernel on the
card).

:class:`TraceSpec` is the declarative form carried by
:class:`repro_torch.fl.scenarios.ScenarioSpec`: a trace source (CSV path or
synthetic-generator params) plus replay knobs, compiled (with caching) only
when a fleet is built.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch import DeviceLike
from repro_torch.fl.traces.synthetic import SyntheticTraceSpec, synthesize_trace
from repro_torch.fl.traces.trace import (
    DEFAULT_ONLINE_STATES,
    DEFAULT_STATE_LOADS,
    STATE_CODES,
    STATE_NAMES,
    ResampledFleet,
    Trace,
    read_trace_csv,
)


def _check_n(fleet: ResampledFleet, n: int) -> None:
    if n != fleet.n:
        raise ValueError(
            f"trace fleet was resampled to {fleet.n} devices but the "
            f"scenario is building {n} — resolve the TraceSpec with the "
            "pool's n_devices (ScenarioSpec.build does this)")


@dataclass(frozen=True, eq=False)
class TraceLoad:
    """Interference replay: per-state load multipliers over the fleet's trace
    timeline (``loads_by_state`` indexed by state code)."""

    fleet: ResampledFleet
    seconds_per_round: float = 3600.0
    loads_by_state: Tuple[float, ...] = DEFAULT_STATE_LOADS

    # a pure function of round_idx (no RNG, no mutable state), so
    # DevicePool.advance_to may jump rounds without stepping through
    stateless_replay = True

    def init_state(self, n: int, rng: np.random.Generator):
        _check_n(self.fleet, n)
        return None

    def step(self, state, rng: np.random.Generator, round_idx: int):
        return state

    def loads(self, state, round_idx: int) -> np.ndarray:
        codes = self.fleet.states_at(round_idx * self.seconds_per_round)
        return np.asarray(self.loads_by_state, dtype=np.float64)[codes]


@dataclass(frozen=True, eq=False)
class TraceAvailability:
    """Reachability replay: a device is online iff its trace state is in
    ``online_states`` (default: everything but ``offline``)."""

    fleet: ResampledFleet
    seconds_per_round: float = 3600.0
    online_states: Tuple[str, ...] = DEFAULT_ONLINE_STATES

    stateless_replay = True

    # verified candidate rounds per next_transition call before returning a
    # conservative hint (misaligned pathological traces only)
    _max_verify = 64

    def _online_lut(self) -> np.ndarray:
        lut = np.zeros(len(STATE_NAMES), dtype=bool)
        for name in self.online_states:
            lut[STATE_CODES[name]] = True
        return lut

    def init_state(self, n: int, rng: np.random.Generator):
        _check_n(self.fleet, n)
        return None

    def step(self, state, rng: np.random.Generator, round_idx: int):
        return state

    def mask(self, state, round_idx: int) -> np.ndarray:
        codes = self.fleet.states_at(round_idx * self.seconds_per_round)
        return self._online_lut()[codes]

    def rounds_per_period(self) -> int:
        return int(np.ceil(self.fleet.trace.period_s / self.seconds_per_round
                           - 1e-9))

    def next_transition(self, state, round_idx: int) -> Optional[int]:
        """EXACT next round at which the sampled mask changes (``None`` =
        never), by candidate-and-verify over the fused state + next-flip
        query (:meth:`ResampledFleet.states_and_next_flip`).

        Each device's next online-status flip bounds the first round its
        sample can change, and no sample moves before the fleet-wide minimum
        candidate, so checking candidates in increasing order finds the
        first real change.  With a whole number of rounds per period the
        samples repeat every ``rounds_per_period()`` rounds, so a changeless
        period proves ``None``; with a misaligned period, after
        ``_max_verify`` changeless candidates the last verified round + 1 is
        returned — a sound conservative hint that the async engine skips
        cheaply.  :meth:`_next_transition_scan` is the per-round oracle."""
        spr = self.seconds_per_round
        fleet = self.fleet
        lut = self._online_lut()
        cur = self.mask(state, round_idx)
        horizon = round_idx + self.rounds_per_period()
        aligned = abs(fleet.trace.period_s % spr) < 1e-9
        r = round_idx
        for _ in range(self._max_verify):
            _, flip_abs = fleet.states_and_next_flip(r * spr, lut)
            # first round whose sample time reaches each device's flip; the
            # -1e-9 slop only ever biases a candidate EARLY (it is verified)
            cand = np.ceil((flip_abs - fleet.phase_s) / spr - 1e-9)
            nxt = float(np.min(cand))        # inf segments never flip
            if not np.isfinite(nxt):
                return None                  # no device ever flips again
            r_c = max(int(nxt), r + 1)
            if aligned and r_c > horizon:
                return None                  # full period, no sampled change
            if not np.array_equal(self.mask(state, r_c), cur):
                return r_c
            r = r_c                          # flip sampled away; keep walking
        return r + 1

    def _next_transition_scan(self, state, round_idx: int) -> Optional[int]:
        """Brute-force per-round scan: the oracle :meth:`next_transition` is
        tested against."""
        R = self.rounds_per_period()
        cur = self.mask(state, round_idx)
        for r in range(round_idx + 1, round_idx + R + 1):
            if not np.array_equal(self.mask(state, r), cur):
                return r
        aligned = abs(self.fleet.trace.period_s
                      % self.seconds_per_round) < 1e-9
        return None if aligned else round_idx + R + 1


# ---------------------------------------------------------------------------
# declarative spec (carried by ScenarioSpec)
# ---------------------------------------------------------------------------

_TRACE_CACHE: Dict[object, Trace] = {}


@dataclass(frozen=True)
class TraceSpec:
    """Declarative trace source + replay knobs.  A pure value: compiling the
    source and bootstrapping the fleet happen only in :meth:`resolve`,
    memoized per source.  Exactly one of ``csv`` (LiveLab-format CSV path)
    or ``synthetic`` (generator params) must be set."""

    csv: Optional[str] = None
    synthetic: Optional[SyntheticTraceSpec] = None
    seconds_per_round: float = 3600.0    # scenario rounds per trace hour
    phase_jitter_s: float = 1800.0       # per-device resample phase jitter
    loads_by_state: Tuple[float, ...] = DEFAULT_STATE_LOADS
    online_states: Tuple[str, ...] = DEFAULT_ONLINE_STATES

    def __post_init__(self):
        if (self.csv is None) == (self.synthetic is None):
            raise ValueError(
                "TraceSpec needs exactly one source: csv=<path> OR "
                "synthetic=SyntheticTraceSpec(...)")

    def trace(self) -> Trace:
        """The compiled source trace (memoized per CSV path / synth spec)."""
        key = ("csv", self.csv) if self.csv else ("synth", self.synthetic)
        if key not in _TRACE_CACHE:
            _TRACE_CACHE[key] = (read_trace_csv(self.csv) if self.csv
                                 else synthesize_trace(self.synthetic))
        return _TRACE_CACHE[key]

    def resolve(self, n_devices: int, seed: int = 0, device: DeviceLike = None
                ) -> Tuple[TraceLoad, TraceAvailability]:
        """Compile + bootstrap to ``n_devices`` and return the coherent
        (load, availability) pair sharing ONE resampled fleet, whose
        segment lookups run on ``device`` (the card unless ``"cpu"``)."""
        fleet = self.trace().resample(n_devices, seed=seed,
                                      phase_jitter_s=self.phase_jitter_s,
                                      device=device)
        return (TraceLoad(fleet, self.seconds_per_round, self.loads_by_state),
                TraceAvailability(fleet, self.seconds_per_round,
                                  self.online_states))
