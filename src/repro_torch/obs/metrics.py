"""Fleet metrics registry: counters, gauges and histograms per round.

A :class:`MetricsRegistry` accumulates between flushes; the recorder calls
:meth:`MetricsRegistry.snapshot` once per round/aggregation to fold the
window into the JSONL round record and reset the window.  Everything is
plain Python + numpy reductions over values the engines already computed —
recording NEVER draws RNG or touches engine state, so metric feeds are
safe to sprinkle through hot paths (the disabled path routes to
:data:`NULL_METRICS`, whose methods are empty).

A counter's increment may be a tensor, a count the card computed: it is
kept as it is and resolved at the snapshot (the recorder's flush, which has
already waited on the card), so the code that counts never waits.

Snapshot shape (all values JSON-native)::

    {"counters":   {name: int},
     "gauges":     {name: float},          # last value set in the window
     "histograms": {name: {"n": int, "mean": float,
                           "min": float, "max": float}}}
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class MetricsRegistry:
    """Per-window metric accumulator (one window = one round record)."""

    def __init__(self):
        self._counters: Dict[str, int] = {}
        self._pending: List[tuple] = []          # (name, tensor count)
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, List[float]] = {}

    def count(self, name: str, inc=1) -> None:
        """Monotone counter within the window (e.g. adversaries merged);
        ``inc`` an int or a tensor holding one."""
        if isinstance(inc, torch.Tensor):
            self._pending.append((name, inc))
            return
        self._counters[name] = self._counters.get(name, 0) + int(inc)

    def _resolve(self) -> None:
        """Fold the tensor counts in: one host copy a device."""
        by_dev: Dict[torch.device, List[tuple]] = {}
        for name, t in self._pending:
            by_dev.setdefault(t.device, []).append((name, t))
        for items in by_dev.values():
            vals = torch.stack([t.reshape(()).to(torch.int64) for _, t in items]).tolist()
            for (name, _), v in zip(items, vals):
                self._counters[name] = self._counters.get(name, 0) + int(v)
        self._pending = []

    def gauge(self, name: str, value) -> None:
        """Point-in-time level (e.g. buffer fill); last write per window wins."""
        self._gauges[name] = float(value)

    def observe(self, name: str, values) -> None:
        """Feed a scalar or array of samples into a histogram (e.g. the
        staleness lags of one merge)."""
        arr = np.atleast_1d(np.asarray(values, dtype=np.float64))
        if arr.size:
            self._hists.setdefault(name, []).extend(float(v) for v in arr)

    def snapshot(self, reset: bool = True) -> dict:
        self._resolve()
        out = {
            "counters": dict(self._counters),
            "gauges": dict(self._gauges),
            "histograms": {
                name: {"n": len(vs), "mean": float(np.mean(vs)),
                       "min": float(np.min(vs)), "max": float(np.max(vs))}
                for name, vs in self._hists.items() if vs},
        }
        if reset:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
        return out


class NullMetrics:
    """The disabled path: every feed is a no-op method call."""

    def count(self, name: str, inc: int = 1) -> None:
        pass

    def gauge(self, name: str, value) -> None:
        pass

    def observe(self, name: str, values) -> None:
        pass

    def snapshot(self, reset: bool = True) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = NullMetrics()
