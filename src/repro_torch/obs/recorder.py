"""Span-based run recorder: the core of :mod:`repro_torch.obs`.

Two implementations of one small protocol:

* :data:`NULL_RECORDER` — the default.  ``enabled`` is False, ``span``
  returns a shared no-op context manager, every feed is an empty method —
  the whole observability layer costs a handful of no-op calls per round
  and NEVER draws RNG or changes control flow, so an unobserved run gives
  the same cohorts and params as it did before the hooks existed.
* :class:`RunRecorder` — opt-in via ``FLConfig.observe``.  Collects
  nestable spans (host wall-time always; virtual time when the caller
  passes a clock callable — the async engines pass their virtual clock),
  per-round metrics snapshots (:mod:`repro_torch.obs.metrics`), profiled op
  timings (:mod:`repro_torch.obs.profiling`) and structured events, and flushes
  one JSON round record per round/aggregation.  With ``out_dir`` set it
  appends records incrementally to ``<out_dir>/run.jsonl`` beside a
  ``manifest.json`` (:mod:`repro_torch.obs.manifest`); the in-memory ``records``
  list is always kept, so tests and callers can introspect without a
  filesystem round-trip.

Span records carry the host's clock (``t0_s``, ``perf_counter`` at entry,
and ``wall_s``, the delta to exit), and when a virtual clock was supplied
``v0_s``/``v1_s`` (virtual time at enter/exit).  Nesting is recorded as a
``/``-joined path ("aggregate/evaluate"), in exit order (children before
parents), so start, end and path give a span's parent and self time.

With CUDA in use each span of a :class:`RunRecorder` also records a timing
event on the current stream at entry and at exit, and ``flush_round``
resolves them after one ``synchronize`` on the window's last event into
``device_s``: the stream's time from the span's entry to its exit (its
kernels plus any wait on the host inside it).  No span fences the card, so
queued work still overlaps host work.  While ``torch.profiler`` runs, each
span also opens a ``record_function`` range of its name, so the program's
spans label the device trace.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch.profiler import record_function

from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullRecorder:
    """The zero-overhead disabled path (a process-wide singleton)."""

    enabled = False
    metrics = NULL_METRICS
    records: List[dict] = []

    def span(self, name: str, clock: Optional[Callable[[], float]] = None):
        return _NULL_SPAN

    def event(self, name: str, **fields) -> None:
        pass

    def record_op(self, name: str, wall_s: float) -> None:
        pass

    def flush_round(self, **fields) -> None:
        pass

    def close(self) -> None:
        pass


NULL_RECORDER = NullRecorder()


def cuda_event():
    """A timing event recorded on the current CUDA stream, or None where
    CUDA is not in use (the default device-event source of a span)."""
    if not torch.cuda.is_initialized():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("rec", "name", "clock", "t0", "v0", "ev0", "range")

    def __init__(self, rec: "RunRecorder", name: str,
                 clock: Optional[Callable[[], float]]):
        self.rec = rec
        self.name = name
        self.clock = clock

    def __enter__(self):
        self.rec._stack.append(self.name)
        self.range = None
        if torch.autograd._profiler_enabled():
            self.range = record_function(self.name)
            self.range.__enter__()
        self.ev0 = self.rec._device_event()
        self.v0 = self.clock() if self.clock is not None else None
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        wall = time.perf_counter() - self.t0
        rec = self.rec
        ev1 = rec._device_event() if self.ev0 is not None else None
        path = "/".join(rec._stack)
        rec._stack.pop()
        entry: Dict[str, Any] = {"span": path, "t0_s": self.t0, "wall_s": wall}
        if self.clock is not None:
            entry["v0_s"] = float(self.v0)
            entry["v1_s"] = float(self.clock())
        if ev1 is not None:
            rec._pending.append((entry, self.ev0, ev1))
        rec._spans.append(entry)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def _json_default(value):
    if hasattr(value, "tolist"):
        return value.tolist()
    if hasattr(value, "item"):
        return value.item()
    return repr(value)


class RunRecorder:
    """Collects spans / metrics / op timings / events into round records."""

    enabled = True

    def __init__(self, out_dir: Optional[str] = None,
                 manifest: Optional[dict] = None,
                 device_event: Callable[[], Any] = cuda_event):
        """``device_event`` makes a span's entry and exit marks: a recorded
        event with ``synchronize()`` and ``elapsed_time(end)`` (ms), or None
        for no device time."""
        self.out_dir = out_dir
        self.manifest = manifest or {}
        self.metrics = MetricsRegistry()
        self.records: List[dict] = []
        self._spans: List[dict] = []
        self._stack: List[str] = []
        self._device_event = device_event
        self._pending: List[tuple] = []     # (span entry, entry event, exit event)
        self._ops: Dict[str, List[float]] = {}
        self._path: Optional[str] = None
        self._fh = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "manifest.json"), "w") as fh:
                json.dump(self.manifest, fh, indent=2,
                          default=_json_default)
                fh.write("\n")
            self._path = os.path.join(out_dir, "run.jsonl")
            self._fh = open(self._path, "w")

    # -- span tracing --------------------------------------------------
    def span(self, name: str, clock: Optional[Callable[[], float]] = None):
        """Nestable timing context.  ``clock`` is an optional virtual-time
        callable sampled at enter/exit (the async engines pass
        ``lambda: engine.now``); host wall-time is always recorded."""
        return _Span(self, name, clock)

    # -- structured events (interleave with round records) -------------
    def event(self, name: str, **fields) -> None:
        self._write({"type": "event", "event": name, **fields})

    # -- profiled op timings (repro_torch.obs.profiling feeds these) ---------
    def record_op(self, name: str, wall_s: float) -> None:
        agg = self._ops.setdefault(name, [0, 0.0])
        agg[0] += 1
        agg[1] += float(wall_s)

    # -- per-round flush ------------------------------------------------
    def flush_round(self, **fields) -> None:
        """Close the current window: one round record with every span, op
        aggregate and metrics snapshot accumulated since the last flush."""
        self._resolve_device_times()
        record = {"type": "round", **fields,
                  "spans": self._spans,
                  "ops": {k: {"n": n, "wall_s": w}
                          for k, (n, w) in sorted(self._ops.items())},
                  "metrics": self.metrics.snapshot(reset=True)}
        self._spans = []
        self._ops = {}
        self._write(record)

    def _resolve_device_times(self) -> None:
        """``device_s`` of every span closed since the last flush: one wait
        on the last exit event (recorded last on the stream), then each
        pair's elapsed time."""
        pending, self._pending = self._pending, []
        if not pending:
            return
        pending[-1][2].synchronize()
        for entry, start, end in pending:
            entry["device_s"] = 1e-3 * start.elapsed_time(end)

    def _write(self, record: dict) -> None:
        self.records.append(record)
        if self._fh is not None:
            self._fh.write(json.dumps(record, default=_json_default) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def make_recorder(spec, cfg=None, scenario: Optional[str] = None):
    """Resolve ``FLConfig.observe`` into a recorder.

    * ``None`` / ``False`` -> :data:`NULL_RECORDER` (the default; zero
      overhead, no files).
    * ``True`` -> in-memory :class:`RunRecorder` (no files; inspect
      ``recorder.records``).
    * a path string -> directory-backed :class:`RunRecorder` writing
      ``manifest.json`` + ``run.jsonl`` there.
    * an object with an ``enabled`` attribute -> used as-is (callers may
      pass a pre-built recorder to share one across servers).
    """
    if spec is None or spec is False:
        return NULL_RECORDER
    if spec is True:
        from repro_torch.obs.manifest import run_manifest

        return RunRecorder(manifest=run_manifest(cfg, scenario=scenario))
    if isinstance(spec, (str, os.PathLike)):
        from repro_torch.obs.manifest import run_manifest

        return RunRecorder(out_dir=os.fspath(spec),
                           manifest=run_manifest(cfg, scenario=scenario))
    if hasattr(spec, "enabled"):
        return spec
    raise ValueError(f"FLConfig.observe={spec!r} is not a recorder spec "
                     "(expected None/False, True, a directory path, or a "
                     "recorder instance)")
