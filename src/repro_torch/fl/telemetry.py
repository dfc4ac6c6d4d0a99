"""Per-device telemetry: the runtime history a selector can learn from.

:class:`DeviceTelemetry` is a struct-of-arrays record (every statistic an
``(N,)`` vector) of each device's EWMA online fraction, observed completion
times, selection / dropout / straggler counts and staleness history.  The
synchronous server feeds it after every round; every update is RNG-free, so
recording never perturbs a run.  The ``"telemetry"`` feature set
(:mod:`repro_torch.core.features`) appends :meth:`feature_block` to the
paper's 6-dim probe state.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# telemetry feature block appended by the "telemetry" feature set, in order
TELEMETRY_FEATURES = (
    "online_frac",        # EWMA online fraction, in [0, 1]
    "comp_mean_s",        # EWMA observed job completion time (s)
    "comp_std_s",         # spread of observed completion times (s)
    "selection_count",    # times selected
    "dropout_rate",       # mid-round dropouts / selections
    "straggler_rate",     # deadline timeouts / selections
    "staleness_ewma",     # EWMA model-version lag of merged updates
    "expected_staleness",  # predicted lag of an update dispatched now
)

# heavy-tailed entries the feature set log-compresses before z-scoring
TELEMETRY_LOG_FEATURES = frozenset({
    "comp_mean_s", "comp_std_s", "selection_count",
    "staleness_ewma", "expected_staleness",
})


class DeviceTelemetry:
    """Vectorized per-device runtime history.  ``alpha`` is the EWMA
    smoothing factor: ``x <- (1 - alpha) * x + alpha * obs``."""

    def __init__(self, n_devices: int, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"EWMA alpha must be in (0, 1], got {alpha}")
        self.n = n_devices
        self.alpha = alpha
        self.online_frac = np.ones(n_devices)      # optimistic prior: online
        self.comp_mean_s = np.zeros(n_devices)     # EWMA completion time
        self.comp_sq_s = np.zeros(n_devices)       # EWMA squared completion
        self.comp_count = np.zeros(n_devices, np.int64)
        self.selection_count = np.zeros(n_devices, np.int64)
        self.dropout_count = np.zeros(n_devices, np.int64)
        self.straggler_count = np.zeros(n_devices, np.int64)
        self.staleness_ewma = np.zeros(n_devices)
        self.last_staleness = np.zeros(n_devices)
        self.merge_count = np.zeros(n_devices, np.int64)
        self.cadence_s = 0.0                       # EWMA time between merges
        self._cadence_seen = False
        # static region labels, set by the server from its DevicePool (a
        # flat fleet is one region, label 0)
        self.region = np.zeros(n_devices, dtype=np.int64)
        self.region_names = ["region0"]

    # ------------------------------------------------------------------
    # region labels (static)
    # ------------------------------------------------------------------
    def set_regions(self, labels: np.ndarray, names) -> None:
        labels = np.asarray(labels, dtype=np.int64)
        if len(labels) != self.n:
            raise ValueError(f"{len(labels)} region labels for {self.n} devices")
        self.region = labels
        self.region_names = list(names)

    def region_mean(self, values: np.ndarray) -> dict:
        """Per-region mean of any (N,) statistic, keyed by region name, e.g.
        ``tel.region_mean(tel.online_frac)``."""
        values = np.asarray(values, dtype=np.float64)
        return {name: float(values[self.region == r].mean())
                for r, name in enumerate(self.region_names)}

    # ------------------------------------------------------------------
    # observation feeds (called by the round engines)
    # ------------------------------------------------------------------
    def observe_availability(self, mask: np.ndarray) -> None:
        """Fleet-wide online mask, once per round."""
        self.online_frac *= 1.0 - self.alpha
        self.online_frac += self.alpha * np.asarray(mask, dtype=np.float64)

    def observe_selection(self, ids: np.ndarray) -> None:
        self.selection_count[ids] += 1

    def observe_dropouts(self, ids: np.ndarray) -> None:
        self.dropout_count[ids] += 1

    def observe_stragglers(self, ids: np.ndarray) -> None:
        self.straggler_count[ids] += 1

    def observe_completions(self, ids: np.ndarray,
                            durations_s: np.ndarray) -> None:
        """End-to-end job durations of devices that finished."""
        ids = np.asarray(ids, dtype=np.int64)
        if len(ids) == 0:
            return
        d = np.asarray(durations_s, dtype=np.float64)
        first = self.comp_count[ids] == 0
        # the first observation seeds the EWMA
        self.comp_mean_s[ids] = np.where(
            first, d, (1.0 - self.alpha) * self.comp_mean_s[ids] + self.alpha * d)
        self.comp_sq_s[ids] = np.where(
            first, d * d,
            (1.0 - self.alpha) * self.comp_sq_s[ids] + self.alpha * d * d)
        self.comp_count[ids] += 1

    def observe_staleness(self, ids: np.ndarray, lags: np.ndarray) -> None:
        """Model-version lags of updates merged into the global model."""
        ids = np.asarray(ids, dtype=np.int64)
        if len(ids) == 0:
            return
        lags = np.asarray(lags, dtype=np.float64)
        first = self.merge_count[ids] == 0
        self.staleness_ewma[ids] = np.where(
            first, lags,
            (1.0 - self.alpha) * self.staleness_ewma[ids] + self.alpha * lags)
        self.last_staleness[ids] = lags
        self.merge_count[ids] += 1

    def observe_cadence(self, dt_s: float) -> None:
        """Interval between consecutive aggregations (the round latency)."""
        if dt_s <= 0.0:
            return
        if not self._cadence_seen:
            self.cadence_s = float(dt_s)
            self._cadence_seen = True
        else:
            self.cadence_s = ((1.0 - self.alpha) * self.cadence_s
                              + self.alpha * float(dt_s))

    # ------------------------------------------------------------------
    # derived views (read by feature sets / policies)
    # ------------------------------------------------------------------
    def expected_completion_s(self, ids: np.ndarray,
                              fallback_s: np.ndarray) -> np.ndarray:
        """EWMA completion time where observed, static estimate otherwise."""
        return np.where(self.comp_count[ids] > 0, self.comp_mean_s[ids],
                        np.asarray(fallback_s, dtype=np.float64))

    def completion_std_s(self, ids: np.ndarray) -> np.ndarray:
        var = self.comp_sq_s[ids] - self.comp_mean_s[ids] ** 2
        return np.sqrt(np.maximum(var, 0.0))

    def dropout_rate(self, ids: np.ndarray) -> np.ndarray:
        return self.dropout_count[ids] / np.maximum(self.selection_count[ids], 1)

    def straggler_rate(self, ids: np.ndarray) -> np.ndarray:
        return (self.straggler_count[ids]
                / np.maximum(self.selection_count[ids], 1))

    def expected_staleness(self, ids: np.ndarray, fallback_completion_s:
                           np.ndarray, cadence_s: Optional[float] = None
                           ) -> np.ndarray:
        """Predicted model-version lag of an update dispatched now: expected
        completion time over the aggregation cadence."""
        cad = cadence_s if cadence_s is not None else self.cadence_s
        if cad <= 0.0:   # before the first aggregation: no cadence yet
            cad = float(np.median(np.asarray(fallback_completion_s))) or 1.0
        exp = self.expected_completion_s(ids, fallback_completion_s)
        return exp / cad

    def feature_block(self, ids: np.ndarray,
                      fallback_completion_s: np.ndarray) -> np.ndarray:
        """(len(ids), len(TELEMETRY_FEATURES)) raw history block, columns in
        :data:`TELEMETRY_FEATURES` order."""
        ids = np.asarray(ids, dtype=np.int64)
        columns = {
            "online_frac": lambda: self.online_frac[ids],
            "comp_mean_s": lambda: self.expected_completion_s(
                ids, fallback_completion_s),
            "comp_std_s": lambda: self.completion_std_s(ids),
            "selection_count": lambda: self.selection_count[ids].astype(
                np.float64),
            "dropout_rate": lambda: self.dropout_rate(ids),
            "straggler_rate": lambda: self.straggler_rate(ids),
            "staleness_ewma": lambda: self.staleness_ewma[ids],
            "expected_staleness": lambda: self.expected_staleness(
                ids, fallback_completion_s),
        }
        return np.stack([columns[name]() for name in TELEMETRY_FEATURES],
                        axis=1)
