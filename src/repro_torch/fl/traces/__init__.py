"""Trace-driven workloads: replayable device traces, ingestion to models.

* :mod:`repro_torch.fl.traces.trace` — the LiveLab-format CSV schema, the
  compiled struct-of-arrays :class:`Trace`, and bootstrap resampling to any
  fleet size (:class:`ResampledFleet`), whose segment lookups run through
  the ``fleet_state`` kernel on the card;
* :mod:`repro_torch.fl.traces.synthetic` — the deterministic synthetic-trace
  generator (:func:`synthesize_trace`);
* :mod:`repro_torch.fl.traces.models` — :class:`TraceLoad` /
  :class:`TraceAvailability` scenario models replaying one shared fleet, and
  the declarative :class:`TraceSpec` carried by ``ScenarioSpec.trace``.

Entry points: the ``trace-livelab`` and ``trace-synthetic-week`` scenarios
(:mod:`repro_torch.fl.scenarios`) and ``FLConfig.trace_csv``.
"""
from repro_torch.fl.traces.models import TraceAvailability, TraceLoad, TraceSpec
from repro_torch.fl.traces.synthetic import SyntheticTraceSpec, synthesize_trace
from repro_torch.fl.traces.trace import (
    DEFAULT_ONLINE_STATES,
    DEFAULT_STATE_LOADS,
    STATE_CODES,
    STATE_NAMES,
    ResampledFleet,
    Trace,
    compile_events,
    read_trace_csv,
    sample_trace_path,
    write_trace_csv,
)

__all__ = [
    "Trace", "ResampledFleet", "compile_events",
    "read_trace_csv", "write_trace_csv", "sample_trace_path",
    "STATE_NAMES", "STATE_CODES",
    "DEFAULT_STATE_LOADS", "DEFAULT_ONLINE_STATES",
    "SyntheticTraceSpec", "synthesize_trace",
    "TraceLoad", "TraceAvailability", "TraceSpec",
]
