"""Structured run observability: spans, metrics, profiling, run records.

The opt-in instrumentation layer for both round engines (``FLConfig
.observe``).  Pieces:

* :mod:`repro_torch.obs.recorder` — span tracing (host wall, CUDA-event
  device time, virtual clock, profiler ranges) and the JSONL run record;
  :data:`NULL_RECORDER` is the zero-overhead, RNG-free disabled default.
* :mod:`repro_torch.obs.metrics` — counters / gauges / histograms flushed per
  round (devices online, buffer fill, staleness distribution, per-tier
  lag, adversaries merged, events per window).
* :mod:`repro_torch.obs.profiling` — ``torch.cuda.synchronize``-fenced
  timing around executor and kernel calls, spans of the active recorder
  where none is in hand, plus the ``torch.profiler`` trace gate.
* :mod:`repro_torch.obs.manifest` — the reproducibility header (config digest,
  scenario, seed, platform, package versions).
* :mod:`repro_torch.obs.log` — the structured logger behind the engines' round
  lines and stall diagnostics.
* :mod:`repro_torch.obs.report` — run-record reduction and the validity
  gate (``check_run``).

The records follow the reference's schema, so the JAX package's
``repro.obs.report`` reads them unchanged.
"""
from repro_torch.obs.log import StructuredLogger
from repro_torch.obs.manifest import config_digest, run_manifest
from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry, NullMetrics
from repro_torch.obs.profiling import (
    active_profiler,
    clear_profiler,
    set_profiler,
    timed_call,
    trace_gate,
)
from repro_torch.obs.recorder import (
    NULL_RECORDER,
    NullRecorder,
    RunRecorder,
    make_recorder,
)

__all__ = [
    "NULL_METRICS",
    "NULL_RECORDER",
    "MetricsRegistry",
    "NullMetrics",
    "NullRecorder",
    "RunRecorder",
    "StructuredLogger",
    "active_profiler",
    "clear_profiler",
    "config_digest",
    "make_recorder",
    "run_manifest",
    "set_profiler",
    "timed_call",
    "trace_gate",
]
