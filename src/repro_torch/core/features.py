"""State featurization for the selection Q-network, as registered feature sets
(numpy, host side; the features equal the reference's exactly).

The raw 6-dim device state (paper §3.1) spans many orders of magnitude, so
features are log-compressed then z-scored per cohort — FedRank only needs
the ranking within a cohort.

* ``"paper6"`` (default) — the paper's state ``(T_comp, T_comm, E_comp,
  E_comm, L_i, D_i)``;
* ``"telemetry"`` — the paper block plus the runtime-history block of
  :class:`repro_torch.fl.telemetry.DeviceTelemetry`.
"""
from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from repro_torch.fl.telemetry import TELEMETRY_FEATURES, TELEMETRY_LOG_FEATURES

STATE_DIM = 6           # (T_comp, T_comm, E_comp, E_comm, L_i, D_i)
FEATURE_DIM = 6


def featurize(states: np.ndarray) -> np.ndarray:
    """states: (M, 6) raw -> (M, 6) cohort-normalized features."""
    s = np.asarray(states, np.float64)
    f = np.concatenate([
        np.log1p(np.maximum(s[:, 0:4], 0.0)),       # latencies/energies
        s[:, 4:5],                                   # training loss (already ~O(1))
        np.log1p(np.maximum(s[:, 5:6], 0.0)),        # data size
    ], axis=1)
    mu = f.mean(axis=0, keepdims=True)
    sd = f.std(axis=0, keepdims=True) + 1e-6
    return ((f - mu) / sd).astype(np.float32)


class Paper6FeatureSet:
    """The paper's 6-dim state, verbatim."""

    name = "paper6"
    state_dim = STATE_DIM       # raw probe-state width
    feature_dim = FEATURE_DIM   # Q-net input width

    def raw_states(self, ctx, ids: np.ndarray,
                   probe_losses: np.ndarray) -> np.ndarray:
        """(len(ids), 6) probe-state matrix for probed devices."""
        s = ctx.sys
        return np.stack([
            s.t_comp[ids], s.t_comm[ids], s.e_comp[ids], s.e_comm[ids],
            probe_losses, ctx.data_sizes[ids].astype(np.float64),
        ], axis=1)

    def bookkeeping_states(self, ctx) -> np.ndarray:
        """(N, 6) pre-probe proxy: static estimates + last observed loss
        (what FedRank ranks to pick its probing cohort)."""
        return np.stack([
            ctx.est_t_round / 5.0, ctx.sys.t_comm,   # comm is load-independent
            ctx.est_e_round / 5.0, ctx.sys.e_comm,
            ctx.last_loss, ctx.data_sizes.astype(float)], axis=1)

    def featurize(self, states: np.ndarray) -> np.ndarray:
        return featurize(states)

    def synthetic_states(self, rng: np.random.Generator,
                         cohort: int) -> np.ndarray:
        """Plausible random raw states for IL demonstration augmentation
        (:func:`repro_torch.core.imitation.augment_demonstrations`); the
        draws come from ``rng`` in the reference's order."""
        return np.stack([
            rng.lognormal(3.0, 1.2, cohort),        # t_comp
            rng.lognormal(2.0, 1.0, cohort),        # t_comm
            rng.lognormal(1.0, 1.2, cohort),        # e_comp
            rng.lognormal(0.0, 1.0, cohort),        # e_comm
            rng.uniform(0.05, 3.0, cohort),         # loss
            rng.lognormal(5.0, 0.8, cohort),        # data size
        ], axis=1)


class TelemetryFeatureSet(Paper6FeatureSet):
    """Paper block (columns ``[0:6]``) + per-device runtime-history block
    (columns ``[6:]``, :data:`TELEMETRY_FEATURES` order).  A context with no
    telemetry gets a zero history block."""

    name = "telemetry"
    state_dim = STATE_DIM + len(TELEMETRY_FEATURES)
    feature_dim = FEATURE_DIM + len(TELEMETRY_FEATURES)

    def _history_block(self, ctx, ids: np.ndarray) -> np.ndarray:
        telemetry = getattr(ctx, "telemetry", None)
        if telemetry is None:
            return np.zeros((len(ids), self.state_dim - STATE_DIM))
        return telemetry.feature_block(ids, ctx.est_t_round[ids])

    def raw_states(self, ctx, ids, probe_losses) -> np.ndarray:
        return np.concatenate([
            super().raw_states(ctx, ids, probe_losses),
            self._history_block(ctx, ids)], axis=1)

    def bookkeeping_states(self, ctx) -> np.ndarray:
        ids = np.arange(ctx.n)
        return np.concatenate([
            super().bookkeeping_states(ctx),
            self._history_block(ctx, ids)], axis=1)

    def featurize(self, states: np.ndarray) -> np.ndarray:
        """Paper transform plus the history block: log-compressed where
        heavy-tailed, raw where already in [0, 1], z-scored per cohort."""
        s = np.asarray(states, np.float64)
        h = s[:, STATE_DIM:STATE_DIM + len(TELEMETRY_FEATURES)].copy()
        log_cols = [j for j, name in enumerate(TELEMETRY_FEATURES)
                    if name in TELEMETRY_LOG_FEATURES]
        h[:, log_cols] = np.log1p(np.maximum(h[:, log_cols], 0.0))
        mu = h.mean(axis=0, keepdims=True)
        sd = h.std(axis=0, keepdims=True) + 1e-6
        hist = ((h - mu) / sd).astype(np.float32)
        return np.concatenate([featurize(s[:, :STATE_DIM]), hist], axis=1)

    def synthetic_states(self, rng: np.random.Generator,
                         cohort: int) -> np.ndarray:
        """Paper block first, then a plausible history block drawn column by
        column in :data:`TELEMETRY_FEATURES` order."""
        draws = {
            "online_frac": lambda: rng.uniform(0.05, 1.0, cohort),
            "comp_mean_s": lambda: rng.lognormal(3.5, 1.0, cohort),
            "comp_std_s": lambda: rng.lognormal(1.5, 1.0, cohort),
            "selection_count": lambda: rng.integers(0, 50, cohort
                                                    ).astype(float),
            "dropout_rate": lambda: rng.uniform(0.0, 0.5, cohort),
            "straggler_rate": lambda: rng.uniform(0.0, 0.5, cohort),
            "staleness_ewma": lambda: rng.lognormal(0.0, 1.0, cohort),
            "expected_staleness": lambda: rng.lognormal(0.5, 1.0, cohort),
        }
        block = np.stack([draws[n]() for n in TELEMETRY_FEATURES], axis=1)
        return np.concatenate([super().synthetic_states(rng, cohort), block],
                              axis=1)


FeatureSet = Paper6FeatureSet  # structural base: every set shares its surface

_FEATURE_SETS: Dict[str, FeatureSet] = {}


def register_feature_set(fs: FeatureSet) -> FeatureSet:
    """Register a feature set instance (duplicate names are an error)."""
    if fs.name in _FEATURE_SETS:
        raise ValueError(f"feature set {fs.name!r} already registered")
    _FEATURE_SETS[fs.name] = fs
    return fs


def get_feature_set(name: Union[str, FeatureSet]) -> FeatureSet:
    """Resolve a feature set by name (instances pass through)."""
    if not isinstance(name, str):
        return name
    try:
        return _FEATURE_SETS[name]
    except KeyError:
        raise KeyError(f"unknown feature set {name!r}; "
                       f"registered: {available_feature_sets()}") from None


def available_feature_sets() -> List[str]:
    return sorted(_FEATURE_SETS)


register_feature_set(Paper6FeatureSet())
register_feature_set(TelemetryFeatureSet())
