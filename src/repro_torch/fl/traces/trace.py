"""Replayable device traces: LiveLab-format CSV -> compiled timelines.

The data-driven scenario path: ingest a per-device usage trace, compile it
into a struct-of-arrays timeline, and bootstrap it to any fleet size — what
:class:`~repro_torch.fl.traces.models.TraceLoad` and
:class:`~repro_torch.fl.traces.models.TraceAvailability` replay.

**CSV schema (LiveLab-style event log).**  One row per state *transition*:

    # period_s: 172800
    device_id,t_s,state
    d00,0,idle
    d00,28800,active
    d00,81000,charging

``t_s`` is seconds from trace start (``0 <= t_s < period_s``); ``state`` is
one of :data:`STATE_NAMES`.  The optional ``# period_s:`` pragma fixes the
replay period (default: the last event time rounded up to a whole day);
replay wraps — the state before a device's first event is its *last* state
of the period.

**Compiled form.**  :class:`Trace` stores every device's timeline CSR-style
(``offsets`` into flat ``t_start``/``state`` arrays).  A fleet-wide "state
at time t" query is one segment lookup over the whole fleet
(:func:`repro_torch.kernels.fleet_state.ops.segment_index`): the CUDA kernel
on the card, its plain PyTorch version on the CPU.  The split segment arrays
and the CSR offsets, which narrow each query's search to its own device, are
uploaded once per device (:meth:`Trace.resident`).

**Resampling.**  :meth:`Trace.resample` bootstraps the source devices (draw
with replacement + per-device phase jitter) to any fleet size, with the
reference's numpy stream, so fleets equal the reference's.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

# Trace state vocabulary, in code order.  ``offline``: unreachable (radio
# off / no power); ``active``: user in the foreground (heavy interference);
# ``idle``: screen off, on battery; ``charging``: idle + plugged in.
STATE_NAMES: Tuple[str, ...] = ("offline", "active", "idle", "charging")
STATE_CODES: Dict[str, int] = {name: i for i, name in enumerate(STATE_NAMES)}

# Default interference multiplier per state (1.0 = device fully free).
# ``offline`` devices are never selectable, so their entry only matters to
# custom availability maps that put them online.
DEFAULT_STATE_LOADS: Tuple[float, ...] = (1.0, 0.2, 0.9, 1.0)

# States in which a device is reachable for FL work by default; pass
# ``online_states=("charging",)`` for charging-window eligibility.
DEFAULT_ONLINE_STATES: Tuple[str, ...] = ("active", "idle", "charging")

DAY_S = 86400.0

_HEADER = "device_id,t_s,state"


@dataclass(frozen=True, eq=False)
class Trace:
    """A compiled multi-device trace (struct-of-arrays, CSR per device).

    ``offsets[d]:offsets[d+1]`` slices device ``d``'s segments out of the
    flat ``t_start``/``state`` arrays.  Per device, ``t_start`` is strictly
    increasing and starts at 0.0 (compilation inserts the wrap-around
    segment); ``state[k]`` holds from ``t_start[k]`` until the next segment
    start (the last segment wraps to the period end).
    """

    device_ids: Tuple[str, ...]
    offsets: np.ndarray            # (D+1,) int64
    t_start: np.ndarray            # (S,) float64, seconds
    state: np.ndarray              # (S,) int8 codes into STATE_NAMES
    period_s: float
    # device index per segment: with t_start, the sorted (device, time)
    # order the segment lookup searches
    _seg_dev: np.ndarray = field(repr=False, default=None)
    # per-online-LUT next-flip tables (see online_flip_tau), keyed by the
    # LUT tuple; a mutable cache is fine on this eq=False value object
    _flip_cache: dict = field(repr=False, default_factory=dict)
    # the split segment arrays, uploaded once per torch device
    _resident: dict = field(repr=False, default_factory=dict)

    def __post_init__(self):
        if self._seg_dev is None:
            object.__setattr__(self, "_seg_dev", np.repeat(
                np.arange(self.n_devices, dtype=np.int64), np.diff(self.offsets)))

    @property
    def n_devices(self) -> int:
        return len(self.device_ids)

    @property
    def n_segments(self) -> int:
        return len(self.t_start)

    def segments_of(self, d: int) -> Tuple[np.ndarray, np.ndarray]:
        """(t_start, state) arrays of source device ``d`` (for tests)."""
        lo, hi = self.offsets[d], self.offsets[d + 1]
        return self.t_start[lo:hi], self.state[lo:hi]

    def equals(self, other: "Trace") -> bool:
        """Semantic equality of the compiled timelines."""
        return (self.device_ids == other.device_ids
                and self.period_s == other.period_s
                and np.array_equal(self.offsets, other.offsets)
                and np.array_equal(self.t_start, other.t_start)
                and np.array_equal(self.state, other.state))

    # ------------------------------------------------------------------
    def resident(self, device: DeviceLike = None):
        """The split segment arrays on ``device``
        (:class:`~repro_torch.kernels.fleet_state.ops.SegmentTable`) with
        their CSR offsets, uploaded on first use (checked for sortedness and
        against :attr:`offsets`), then cached."""
        from repro_torch.kernels.fleet_state.ops import upload_segments

        dev = resolve_device(device)
        key = str(dev)
        if key not in self._resident:
            self._resident[key] = upload_segments(
                self._seg_dev, self.t_start, dev, offsets=self.offsets)
        return self._resident[key]

    def states_at(self, devices: np.ndarray, t_s: np.ndarray,
                  device: DeviceLike = None) -> np.ndarray:
        """State codes of source ``devices`` at trace times ``t_s`` (both
        broadcastable to one shape): one global segment lookup on
        ``device`` through
        :func:`repro_torch.kernels.fleet_state.ops.segment_index`."""
        from repro_torch.kernels.fleet_state.ops import segment_index

        idx = segment_index(self.resident(device), self.period_s, devices, t_s)
        return self.state[idx]

    def online_flip_tau(self, online_lut: np.ndarray) -> np.ndarray:
        """Per-segment trace time of the device's next ONLINE-STATUS flip
        under ``online_lut`` (bool per state code), ``inf`` where the status
        never changes.  Times are in the segment's own period frame and may
        exceed ``period_s`` (the flip wraps into the next period); memoized
        per LUT."""
        lut = np.asarray(online_lut, dtype=bool)
        key = tuple(lut.tolist())
        hit = self._flip_cache.get(key)
        if hit is not None:
            return hit
        flip = np.full(self.n_segments, np.inf)
        for d in range(self.n_devices):
            lo, hi = int(self.offsets[d]), int(self.offsets[d + 1])
            onl = lut[self.state[lo:hi]]
            if onl.all() or not onl.any():
                continue                     # status constant: never flips
            # double the period so "next change after segment k" never wraps
            # out of range; change points are where consecutive segments
            # differ in STATUS (both may be online in different states)
            onl2 = np.concatenate([onl, onl])
            ts2 = np.concatenate([self.t_start[lo:hi],
                                  self.t_start[lo:hi] + self.period_s])
            change = np.flatnonzero(onl2[1:] != onl2[:-1]) + 1
            pos = np.searchsorted(change, np.arange(hi - lo), side="right")
            flip[lo:hi] = ts2[change[pos]]
        self._flip_cache[key] = flip
        return flip

    def resample(self, n: int, seed: int = 0, phase_jitter_s: float = 1800.0,
                 device: DeviceLike = None) -> "ResampledFleet":
        """Bootstrap the trace to an ``n``-device fleet whose lookups run on
        ``device``: each fleet device replays one source device (drawn with
        replacement) shifted by a per-device phase jitter.  Deterministic in
        ``(trace, n, seed)``; the rng is salted so it never correlates with a
        :class:`~repro_torch.fl.simulation.DevicePool` built from the same
        seed."""
        rng = np.random.default_rng([seed, 0x7ACE])
        src = rng.integers(0, self.n_devices, size=n)
        phase = (rng.uniform(-phase_jitter_s, phase_jitter_s, size=n)
                 % self.period_s if phase_jitter_s > 0.0 else np.zeros(n))
        return ResampledFleet(trace=self, src=src, phase_s=phase,
                              device=resolve_device(device))


@dataclass(frozen=True, eq=False)
class ResampledFleet:
    """An ``n``-device fleet view over a :class:`Trace`: per fleet device a
    source-device index and a phase offset.  All queries are vectorized over
    the whole fleet and run on ``device``."""

    trace: Trace
    src: np.ndarray        # (n,) int64 source-device index
    phase_s: np.ndarray    # (n,) float64 per-device phase shift
    device: torch.device   # where the segment lookups run
    # one-entry (t_s, codes) memo: TraceLoad and TraceAvailability read the
    # same instant every round, so the second lookup is free
    _memo: list = field(repr=False, default_factory=lambda: [None, None])

    @property
    def n(self) -> int:
        return len(self.src)

    def states_at(self, t_s: float) -> np.ndarray:
        """(n,) state codes of the whole fleet at trace time ``t_s``."""
        if self._memo[0] != t_s:
            self._memo[0] = t_s
            self._memo[1] = self.trace.states_at(self.src, t_s + self.phase_s,
                                                 self.device)
        return self._memo[1]

    def states_and_next_flip(self, t_s: float, online_lut: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused query at trace time ``t_s``: (n,) state codes plus, per
        device, the absolute phase-frame time (comparable with
        ``t_s + phase_s``) of its next online-status flip under
        ``online_lut`` (``inf`` = never) — one segment lookup for both."""
        from repro_torch.kernels.fleet_state.ops import fleet_state_at

        tr = self.trace
        return fleet_state_at(tr.resident(self.device), tr.state,
                              tr.online_flip_tau(online_lut), tr.period_s,
                              self.src, t_s + self.phase_s)


# ---------------------------------------------------------------------------
# ingestion / emission
# ---------------------------------------------------------------------------


def compile_events(events: Dict[str, List[Tuple[float, int]]],
                   period_s: float) -> Trace:
    """Compile per-device ``(t_s, state_code)`` event lists into a
    :class:`Trace`.  Devices are ordered by id; per device, events are
    sorted by time, consecutive duplicate states merged, and the wrap-around
    segment ``[0, first_event)`` (holding the device's last state) inserted
    when the first event starts after 0."""
    if not events:
        raise ValueError("trace has no devices")
    if period_s <= 0:
        raise ValueError(f"period_s must be positive, got {period_s}")
    device_ids = tuple(sorted(events))
    offsets = [0]
    t_all: List[float] = []
    s_all: List[int] = []
    for dev in device_ids:
        # stable sort on time ONLY: same-instant events keep input order, so
        # "later event wins" means later in the log, not larger code
        evs = sorted(events[dev], key=lambda e: e[0])
        if not evs:
            raise ValueError(f"device {dev!r} has no events")
        for t, code in evs:
            if not 0.0 <= t < period_s:
                raise ValueError(
                    f"device {dev!r} event at t={t} outside [0, {period_s})")
            if not 0 <= code < len(STATE_NAMES):
                raise ValueError(f"device {dev!r}: unknown state code {code}")
        if evs[0][0] > 0.0:                 # wrap: pre-first-event state is
            evs = [(0.0, evs[-1][1])] + evs  # the device's last state
        merged: List[Tuple[float, int]] = []
        for t, code in evs:
            if merged and merged[-1][0] == t:
                merged.pop()                 # same instant: later event wins
            if not (merged and merged[-1][1] == code):
                merged.append((t, code))     # drop no-op transitions
        t_all.extend(t for t, _ in merged)
        s_all.extend(c for _, c in merged)
        offsets.append(len(t_all))
    return Trace(device_ids=device_ids,
                 offsets=np.asarray(offsets, dtype=np.int64),
                 t_start=np.asarray(t_all, dtype=np.float64),
                 state=np.asarray(s_all, dtype=np.int8),
                 period_s=float(period_s))


def read_trace_csv(path: str) -> Trace:
    """Ingest a LiveLab-format CSV (see module docstring) into a compiled
    :class:`Trace`."""
    events: Dict[str, List[Tuple[float, int]]] = {}
    period_s = None
    with open(path) as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line:
                continue
            if line.startswith("#"):
                body = line.lstrip("#").strip()
                if body.startswith("period_s"):
                    period_s = float(body.split(":", 1)[1])
                continue
            if line == _HEADER:
                continue
            parts = line.split(",")
            if len(parts) != 3:
                raise ValueError(f"{path}:{lineno}: expected "
                                 f"'{_HEADER}', got {line!r}")
            dev, t_s, state = parts
            if state not in STATE_CODES:
                raise ValueError(f"{path}:{lineno}: unknown state {state!r} "
                                 f"(expected one of {STATE_NAMES})")
            events.setdefault(dev, []).append((float(t_s), STATE_CODES[state]))
    if not events:
        raise ValueError(f"{path}: no trace rows")
    if period_s is None:                     # default: next whole day
        t_max = max(t for evs in events.values() for t, _ in evs)
        period_s = DAY_S * max(1.0, np.ceil((t_max + 1.0) / DAY_S))
    return compile_events(events, period_s)


def write_trace_csv(trace: Trace, path: str) -> None:
    """Emit a compiled :class:`Trace` back to the CSV schema.  Round-trip
    safe: ``read_trace_csv(path).equals(trace)`` after writing."""
    out_dir = os.path.dirname(os.path.abspath(path))
    os.makedirs(out_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# period_s: {_fmt(trace.period_s)}\n")
        f.write(_HEADER + "\n")
        for d, dev in enumerate(trace.device_ids):
            t_start, state = trace.segments_of(d)
            for t, code in zip(t_start, state):
                f.write(f"{dev},{_fmt(t)},{STATE_NAMES[code]}\n")


def _fmt(t: float) -> str:
    """Shortest exact decimal for a float time: integers stay integral
    (``18720`` not ``18720.0``), everything else uses ``repr``'s
    round-trip-exact form."""
    t = float(t)
    return str(int(t)) if t == int(t) else repr(t)


def sample_trace_path() -> str:
    """Path of the shipped sample LiveLab-format fixture (the
    ``trace-livelab`` scenario's default source), this package's own copy."""
    return os.path.join(os.path.dirname(__file__), "data", "sample_livelab.csv")
