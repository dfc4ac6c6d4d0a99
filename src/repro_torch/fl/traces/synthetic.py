"""Deterministic synthetic-trace generator: a realistic device week.

No external data is needed to run trace scenarios: this generator renders a
LiveLab-shaped multi-day trace — nightly charging windows, daytime usage
sessions, a weekend shift and occasional offline spells — from one seeded
numpy generator, with the reference's draws in the reference's order, so
``(spec)`` determines the trace and it equals the reference's.

Each device gets a *persona* (habitual charge hour, usage intensity, offline
propensity), then each day is rendered on a 1-minute grid and compressed
into state segments: **charging** (one nightly ~7 h window), **active**
(Poisson-many lognormal foreground sessions, more and later on weekends),
**offline** (with ``offline_prob_per_day``, one unreachable block) and
**idle** (everything else).  Precedence offline > charging > active > idle.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.fl.traces.trace import DAY_S, STATE_CODES, Trace, compile_events

_MIN_PER_DAY = 1440
_OFFLINE = STATE_CODES["offline"]
_ACTIVE = STATE_CODES["active"]
_IDLE = STATE_CODES["idle"]
_CHARGING = STATE_CODES["charging"]


@dataclass(frozen=True)
class SyntheticTraceSpec:
    """Parameters of one synthetic trace — a pure value: the same spec
    always synthesizes the same trace (``seed`` is part of the spec)."""

    n_devices: int = 32
    days: int = 7
    seed: int = 0
    charge_hour: float = 22.5          # fleet-mean charging start (h)
    charge_hour_spread: float = 1.5    # per-device persona spread (h)
    charge_duration_h: float = 7.0
    sessions_per_day: float = 3.0      # weekday foreground sessions (Poisson)
    weekend_sessions_factor: float = 1.8
    session_minutes: float = 25.0      # lognormal median session length
    offline_prob_per_day: float = 0.25
    offline_minutes: float = 90.0      # mean unreachable-block length

    @property
    def period_s(self) -> float:
        return self.days * DAY_S


def synthesize_trace(spec: SyntheticTraceSpec) -> Trace:
    """Render ``spec`` into a compiled :class:`~repro_torch.fl.traces.trace.Trace`
    (1-minute resolution, compressed to state segments)."""
    rng = np.random.default_rng([spec.seed, 0x51D])
    n_min = spec.days * _MIN_PER_DAY
    events = {}
    for d in range(spec.n_devices):
        # persona draws come before any per-day draw, so adding days never
        # reshuffles who a device is
        my_charge_h = spec.charge_hour + rng.normal(0.0, spec.charge_hour_spread)
        my_sessions = max(0.5, spec.sessions_per_day * rng.lognormal(0.0, 0.3))
        my_offline_p = min(1.0, spec.offline_prob_per_day * rng.lognormal(0.0, 0.4))

        grid = np.full(n_min, _IDLE, dtype=np.int8)
        for day in range(spec.days):
            weekend = day % 7 >= 5
            base = day * _MIN_PER_DAY
            # nightly charging window (may cross midnight; modulo wraps it)
            start = base + int((my_charge_h + rng.normal(0.0, 0.5)) * 60.0)
            dur = max(60, int((spec.charge_duration_h
                               + rng.normal(0.0, 0.75)) * 60.0))
            grid[np.arange(start, start + dur) % n_min] = _CHARGING
            # foreground sessions: daytime, later and more on weekends
            lam = my_sessions * (spec.weekend_sessions_factor if weekend else 1.0)
            for _ in range(int(rng.poisson(lam)) + 1):
                lo = 9.5 if weekend else 8.0
                s = base + int(rng.uniform(lo, 22.0) * 60.0)
                m = max(5, int(spec.session_minutes * rng.lognormal(0.0, 0.6)))
                sl = np.arange(s, s + m) % n_min
                grid[sl] = np.where(grid[sl] == _CHARGING, grid[sl], _ACTIVE)
            # offline spell (overrides everything)
            if rng.random() < my_offline_p:
                s = base + int(rng.uniform(7.0, 20.0) * 60.0)
                m = max(15, int(rng.exponential(spec.offline_minutes)))
                grid[np.arange(s, s + m) % n_min] = _OFFLINE

        # compress the minute grid into (t_s, state) transition events
        change = np.flatnonzero(np.diff(grid)) + 1
        starts = np.concatenate([[0], change])
        events[f"d{d:03d}"] = [(float(m) * 60.0, int(grid[m])) for m in starts]
    return compile_events(events, spec.period_s)
