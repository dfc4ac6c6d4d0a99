"""FL server: synchronous round orchestration via RoundPlan + ClientExecutor.

Every round is a :class:`repro_torch.fl.engine.RoundPlan` built from the
policy, then executed uniformly:

  1. PROBE  — every device in ``plan.probe_ids`` runs ``plan.probe_epochs``
     local epochs, revealing its state s_i = (T_comp, T_comm, E_comp,
     E_comm, L_i, D_i); non-probing baselines skip this stage.
  2. SELECT — the policy cuts the cohort to K survivors, then the scenario's
     failure model decides who drops mid-round or misses the deadline.
  3. COMPLETE — survivors run ``plan.completion_epochs`` further epochs
     (resuming from probed params when probed) and upload their updates.
  4. FedAvg aggregation, global eval, reward (paper Eq. 1), policy feedback.

Model weights, client data and every training step live on the server's
``device`` (the card unless ``device="cpu"``); the fleet simulator, the
scenario RNG streams and the virtual clock stay numpy on the host, so
cohorts, failures and the clock follow the reference exactly.

Client work goes to a pluggable executor (``FLConfig.executor``):
``"sequential"`` trains client by client, ``"vmapped"`` each cohort bucket
as one batched step (:mod:`repro_torch.fl.engine`).

Rounds come in two regimes (``FLConfig.mode``): ``"sync"`` runs the barrier
loop above, ``"async"`` (or ``executor="async"``) hands the run to
:class:`repro_torch.fl.async_engine.AsyncRoundEngine` through
:meth:`FLServer.run_async`, and history records one entry per *aggregation*
with the absolute virtual clock as ``cum_time``.  A trace scenario (or
``FLConfig.trace_csv``) replays device timelines whose segment lookups run
on the server's device.

A regioned fleet (a scenario with regions, or ``FLConfig.regions``) or an
explicit ``FLConfig.topology`` routes both regimes through the hierarchical
drivers of :mod:`repro_torch.fl.topology`.  An attack (``FLConfig.attack``,
else the scenario's) corrupts adversarial uploads after training and before
aggregation, and ``FLConfig.aggregator`` picks the merge rule at every merge
site (:mod:`repro_torch.fl.aggregation`).

``FLConfig.observe`` opts a run into structured observability
(:mod:`repro_torch.obs`): spans per round stage, per-round metrics, fenced
executor and kernel op timings, and JSONL run records.  Off (the default),
the recorder is the shared no-op ``NULL_RECORDER``, which draws no random
numbers and changes no result.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.data.loader import FederatedData
from repro_torch.fl.aggregation import AGGREGATORS, robust_aggregate
from repro_torch.fl.engine import (
    COMPLETE_SEED_STRIDE,
    PROBE_SEED_STRIDE,
    ClientExecutor,
    ClientRequest,
    build_requests,
    build_round_plan,
    executor_label,
    make_executor,
)
from repro_torch.fl.scenarios import build_scenario, get_scenario, split_by_weight
from repro_torch.fl.traces import TraceSpec
from repro_torch.fl.simulation import (
    DevicePool,
    RoundSystemState,
    plan_round_energy,
    plan_round_latency,
    static_estimates,
)
from repro_torch.fl.telemetry import DeviceTelemetry
from repro_torch.obs import NULL_RECORDER, StructuredLogger, make_recorder
from repro_torch.obs import profiling as _profiling

Params = Dict[str, torch.Tensor]


def _empty_ids() -> np.ndarray:
    return np.empty(0, dtype=np.int64)


@dataclass
class FLConfig:
    n_devices: int = 100
    k_select: int = 10
    rounds: int = 50
    l_ep: int = 5                 # local epochs per round (paper setting)
    local_batch: int = 32
    lr: float = 0.05
    alpha: float = 2.0            # latency penalty exponent (paper: 2)
    beta: float = 2.0             # energy penalty exponent (paper: 2)
    t_budget: Optional[float] = None   # developer-preferred round duration T
    e_budget: Optional[float] = None   # developer-preferred round energy E
    prox_mu: float = 0.0          # >0 => FedProx local objective
    scenario: str = "uniform"     # fleet environment (repro_torch.fl.scenarios)
    executor: str = "sequential"  # client-executor name (repro_torch.fl.engine)
    feature_set: str = "paper6"   # probe-state feature set on RoundContext
    #                               (repro_torch.core.features)
    aggregator: str = "mean"      # merge rule (repro_torch.fl.aggregation):
    #                               mean | trimmed_mean | coordinate_median
    #                               | krum | multi_krum; "mean" is fedavg;
    #                               applied at every merge site (sync round,
    #                               async buffer, topology tiers)
    agg_trim: int = 1             # trimmed_mean: values cut per side/coord
    agg_f: int = 1                # krum/multi_krum: tolerated adversaries
    agg_m: int = 0                # multi_krum: updates kept (0 => m - f)
    trace_csv: Optional[str] = None   # LiveLab-format trace CSV replayed as
    #                               the scenario's load+availability (swaps
    #                               the named scenario's TraceSpec source)
    failure_rate: float = 0.0     # extra Bernoulli dropout layered on top of
    #                               the scenario's failure model
    mode: str = "sync"            # round regime: "sync" barrier loop or
    #                               "async" buffered aggregation
    #                               (repro_torch.fl.async_engine)
    buffer_size: int = 0          # async: aggregate every B arrivals
    #                               (0 => k_select)
    async_concurrency: int = 0    # async: max outstanding updates, in flight
    #                               + completed-but-unmerged (0 =>
    #                               buffer_size; must be >= buffer_size)
    staleness: str = "constant"   # async update weighting vs model-version
    #                               lag: constant | polynomial | hinge
    staleness_a: float = 0.5      # polynomial exponent / hinge decay slope
    staleness_b: int = 4          # hinge: lag tolerated before decay
    async_tick_s: float = 0.0     # seconds of virtual clock per scenario
    #                               round (0 => median static round latency)
    async_events: str = "batched"  # event-loop stepping: "batched" (whole
    #                               event windows per step) | "sequential"
    #                               (one event instant per step — the
    #                               parity oracle)
    topology: Any = None          # hierarchical aggregation topology
    #                               (repro_torch.fl.topology): a registered
    #                               name, an AggregationTopology, or None —
    #                               None builds one when the fleet declares
    #                               regions, else the run is flat
    regions: int = 0              # split an unregioned fleet into this many
    #                               equal contiguous regions
    region_budgets: Any = None    # per-region selection budgets k_r: dict
    #                               name->k or a sequence in region order
    #                               (None => even split of k_select)
    region_exec: str = "stacked"  # hierarchical rounds: "stacked" runs every
    #                               region's cohort in ONE executor call per
    #                               stage, "sequential" one call per region
    #                               (identical results)
    attack: Any = None            # AttackModel corrupting uploads after
    #                               training, before aggregation (None =>
    #                               the scenario's, if it declares one)
    observe: Any = None           # structured observability (repro_torch.obs):
    #                               None/False = the no-op recorder (default;
    #                               RNG-free, results unchanged), True =
    #                               record spans/metrics in memory, a
    #                               directory path = also write manifest.json
    #                               + run.jsonl there, or a recorder instance
    log_level: str = ""           # structured-log threshold (repro_torch.obs.log):
    #                               debug | info | warning | error
    #                               ("" => $REPRO_LOG_LEVEL => warning)
    seed: int = 0


def _check_mode(cfg: FLConfig) -> None:
    if cfg.mode not in ("sync", "async"):
        raise ValueError(f"unknown mode {cfg.mode!r}; expected 'sync' or 'async'")


@dataclass
class RoundContext:
    """Everything a selection policy may observe at the start of a round."""

    round: int
    n: int
    k: int
    sys: RoundSystemState            # true per-round system state (probing reveals)
    est_t_round: np.ndarray          # (N,) static estimate of full-round latency
    est_e_round: np.ndarray          # (N,) static estimate of full-round energy
    data_sizes: np.ndarray           # (N,)
    last_loss: np.ndarray            # (N,) most recent observed training loss
    loss_age: np.ndarray             # (N,) rounds since last_loss was observed
    available: np.ndarray = None     # (N,) bool: online this round (policies
    #                                  MUST only probe/select available devices)
    selection_count: np.ndarray = None  # (N,) times each device was selected
    telemetry: Optional[DeviceTelemetry] = None   # per-device runtime history
    feature_set: Any = None          # FeatureSet shaping probe_states
    region: np.ndarray = None        # (N,) static region labels (flat fleet:
    #                                  all zeros — repro_torch.fl.topology)
    region_id: Optional[int] = None  # set when this context is one region's
    #                                  slice of a hierarchical round
    region_name: Optional[str] = None
    rng: np.random.Generator = field(repr=False, default=None)

    def available_ids(self) -> np.ndarray:
        """Ids a policy may legally probe or select this round."""
        if self.available is None:
            return np.arange(self.n)
        return np.flatnonzero(self.available)

    def probe_states(self, ids: np.ndarray, probe_losses: np.ndarray) -> np.ndarray:
        """Raw state matrix (len(ids), feature_set.state_dim) for probed
        devices; columns [0:6] are the paper's 6-dim state."""
        return self.feature_set.raw_states(self, ids, probe_losses)

    def expected_staleness(self, ids: np.ndarray) -> np.ndarray:
        """Predicted model-version lag of an update dispatched now from each
        device in ``ids``: telemetry-estimated completion time (the static
        estimate before any observation) over the observed aggregation
        cadence.  Zeros without telemetry (hand-built contexts)."""
        ids = np.asarray(ids, dtype=np.int64)
        if self.telemetry is None:
            return np.zeros(len(ids))
        return self.telemetry.expected_staleness(ids, self.est_t_round[ids])


class SelectionPolicy(Protocol):
    name: str
    needs_probing: bool

    def probe_set(self, ctx: RoundContext) -> np.ndarray: ...

    def select(self, ctx: RoundContext,
               probe_ids: Optional[np.ndarray],
               probe_states: Optional[np.ndarray]) -> np.ndarray: ...

    def observe(self, ctx: RoundContext, result: "RoundResult",
                probe_ids: Optional[np.ndarray],
                probe_states: Optional[np.ndarray]) -> None: ...


@dataclass
class RoundResult:
    round: int
    selected: np.ndarray
    probe_set: np.ndarray
    acc: float
    test_loss: float
    r_t: float                    # round latency (s)
    r_e: float                    # round energy (J)
    d_acc: float
    reward: float
    cum_time: float
    cum_energy: float
    failed: np.ndarray = field(default_factory=_empty_ids)
    #                             selected devices that dropped mid-round
    stragglers: np.ndarray = field(default_factory=_empty_ids)
    #                             selected devices that missed the deadline
    adversaries: np.ndarray = field(default_factory=_empty_ids)
    #                             selected devices that were adversarial this
    #                             round (repro_torch.fl.attacks); empty
    #                             without an attack
    n_available: int = -1         # fleet devices online this round
    # --- async-mode fields (one record per *aggregation*; the defaults keep
    #     synchronous records unchanged) ---
    mean_staleness: float = 0.0   # mean model-version lag of merged updates
    max_staleness: int = 0        # worst lag in the merged buffer
    n_pending: int = 0            # jobs still in flight at aggregation time
    tier_staleness: Dict[str, float] = field(default_factory=dict)
    #                             hierarchical runs: mean per-tier lag of the
    #                             merged updates, keyed "region:<name>" /
    #                             "root" (empty on flat runs)
    host_time_s: float = 0.0      # host wall-clock seconds for the record
    #                             (sync: the round; async: since the previous
    #                             aggregation), device work included (ends in
    #                             a host sync)
    executor: str = ""            # executor that ran the client work, wrappers
    #                             unwrapped (e.g. "async[sequential]")


def paper_reward(d_acc: float, r_t: float, r_e: float, t_budget: float,
                 e_budget: float, alpha: float, beta: float) -> float:
    """Eq. (1): R = dAcc * (T/R_T)^{1(T<R_T) a} * (E/R_E)^{1(E<R_E) b}."""
    r = d_acc
    if t_budget < r_t:
        r *= (t_budget / r_t) ** alpha
    if e_budget < r_e:
        r *= (e_budget / r_e) ** beta
    return float(r)


class FLServer:
    def __init__(self, cfg: FLConfig, task, data: FederatedData,
                 pool: Optional[DevicePool] = None,
                 executor: Optional[ClientExecutor] = None,
                 device: DeviceLike = None):
        _check_mode(cfg)
        if cfg.aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {cfg.aggregator!r}; "
                             f"expected one of {AGGREGATORS}")
        from repro_torch.core.features import get_feature_set   # deferred:
        #                                  repro_torch.core imports repro_torch.fl

        self.device = resolve_device(device)
        self.cfg = cfg
        self.task = task
        self.data = data
        self.executor = executor or make_executor(cfg.executor)
        scenario_kw = {}
        if cfg.trace_csv is not None:
            # replay the user's trace under the named scenario's tier mix and
            # failure model; a trace scenario keeps its replay knobs and
            # swaps the SOURCE only
            prior = get_scenario(cfg.scenario).trace
            scenario_kw["trace"] = (
                dataclasses.replace(prior, csv=cfg.trace_csv, synthetic=None)
                if prior is not None else TraceSpec(csv=cfg.trace_csv))
        # trace lookups run where the model does
        self.pool = pool or build_scenario(cfg.scenario, cfg.n_devices,
                                           seed=cfg.seed, device=self.device,
                                           **scenario_kw)
        if cfg.failure_rate > 0:
            # extra Bernoulli dropout over the scenario's failure model
            self.pool.failures = dataclasses.replace(
                self.pool.failures,
                dropout=max(self.pool.failures.dropout, cfg.failure_rate))
        if cfg.regions and cfg.regions > 1:
            if self.pool.n_regions > 1 and self.pool.n_regions != cfg.regions:
                raise ValueError(
                    f"FLConfig.regions={cfg.regions} conflicts with the "
                    f"scenario's {self.pool.n_regions} declared regions")
            if self.pool.n_regions == 1:
                # carve an unregioned fleet into equal contiguous regions
                counts = split_by_weight(cfg.n_devices, [1.0] * cfg.regions)
                self.pool.region = np.repeat(np.arange(cfg.regions), counts)
                self.pool.n_regions = cfg.regions
                self.pool.region_names = [f"region{i}" for i in range(cfg.regions)]
        # an explicit FLConfig.attack overrides the scenario's; attack draws
        # come from their own RNG stream, so attack=None runs consume exactly
        # the RNG of an unattacked run
        self.attack = (cfg.attack if cfg.attack is not None
                       else getattr(self.pool, "attack", None))
        self.rng = np.random.default_rng(cfg.seed + 17)
        self.feature_set = get_feature_set(cfg.feature_set)  # validates early
        self.telemetry = DeviceTelemetry(cfg.n_devices)
        self.telemetry.set_regions(self.pool.region, self.pool.region_names)
        from repro_torch.fl.topology import resolve_topology   # deferred:
        #                                  topology imports the server's types

        self.topology = resolve_topology(cfg, self.pool)
        self.global_params: Params = task.init(cfg.seed, device=self.device)
        # the whole train/test set lives on the device; a client's shard is
        # a device-side gather by its index list
        self._train_x = torch.as_tensor(data.train.x, device=self.device)
        self._train_y = torch.as_tensor(data.train.y, device=self.device)
        self._test_x = torch.as_tensor(data.test.x, device=self.device)
        self._test_y = torch.as_tensor(data.test.y, device=self.device)
        self._client_idx = [torch.as_tensor(ix, device=self.device)
                            for ix in data.client_indices]
        self.data_sizes = np.array([data.client_size(i) for i in range(cfg.n_devices)])
        self.last_loss = np.full(cfg.n_devices, 3.0)
        self.loss_age = np.zeros(cfg.n_devices)
        self.history: List[RoundResult] = []
        self._static_est = None   # static estimates are round-invariant
        self._cum_time = 0.0
        self._cum_energy = 0.0
        self._last_acc = self._evaluate()[0]
        # budgets from the static profile if not given: the median device's
        # full-round cost (a "reasonable phone" finishing on time)
        est_t, est_e = self._static_round_estimates()
        self.t_budget = cfg.t_budget or float(np.median(est_t))
        self.e_budget = cfg.e_budget or float(np.median(est_e)) * cfg.k_select
        # observability: created after the init-time evaluate so round 0's
        # record starts clean; an enabled recorder is also the destination of
        # the kernel and executor op timings
        self.obs = make_recorder(cfg.observe, cfg=cfg, scenario=cfg.scenario)
        self.log = StructuredLogger(level=cfg.log_level or None, recorder=self.obs)
        self._executor_label = executor_label(self.executor)
        if self.obs.enabled:
            _profiling.set_profiler(self.obs)

    # ------------------------------------------------------------------
    @property
    def selection_count(self) -> np.ndarray:
        """The telemetry's per-device counter (what ``ctx.selection_count``
        copies)."""
        return self.telemetry.selection_count

    def _flops_per_epoch(self) -> np.ndarray:
        return self.task.flops_per_sample() * self.data_sizes

    def _static_round_estimates(self):
        if self._static_est is None:
            self._static_est = static_estimates(
                self.pool, self._flops_per_epoch(), self.task.param_bytes(),
                self.cfg.l_ep)
        return self._static_est

    @torch.no_grad()
    def _evaluate(self):
        """(accuracy, loss) on the test set in batches of 512, weighted by
        batch size; one device->host copy at the end."""
        bs = 512
        n = len(self._test_y)
        accs, losses, sizes = [], [], []
        # getattr: __init__ evaluates once before the recorder exists
        with getattr(self, "obs", NULL_RECORDER).span("evaluate"):
            for i in range(0, n, bs):
                b = {"x": self._test_x[i:i + bs], "y": self._test_y[i:i + bs]}
                accs.append(self.task.accuracy(self.global_params, b))
                losses.append(self.task.loss(self.global_params, b))
                sizes.append(len(b["y"]))
            accs, losses = torch.stack([torch.stack(accs),
                                        torch.stack(losses)]).cpu().tolist()
        return (sum(a * s for a, s in zip(accs, sizes)) / n,
                sum(l * s for l, s in zip(losses, sizes)) / n)

    def _ctx(self, k: Optional[int] = None,
             available: Optional[np.ndarray] = None,
             round_idx: Optional[int] = None) -> RoundContext:
        """Policy-facing round context.  The async engine overrides ``k``
        (wave size), ``available`` (online AND idle) and ``round_idx`` (its
        dispatch-wave counter); the sync path uses the defaults."""
        sys = self.pool.system_state(self._flops_per_epoch(), self.task.param_bytes())
        est_t, est_e = self._static_round_estimates()
        return RoundContext(
            round=len(self.history) if round_idx is None else round_idx,
            n=self.cfg.n_devices, k=k or self.cfg.k_select,
            sys=sys, est_t_round=est_t, est_e_round=est_e,
            data_sizes=self.data_sizes, last_loss=self.last_loss.copy(),
            loss_age=self.loss_age.copy(),
            available=(self.pool.available() if available is None
                       else available),
            selection_count=self.selection_count.copy(),
            telemetry=self.telemetry, feature_set=self.feature_set,
            region=self.pool.region, rng=self.rng)

    def _client_data(self, i: int):
        idx = self._client_idx[i]
        return self._train_x[idx], self._train_y[idx]

    def _execute(self, requests: Sequence[ClientRequest]):
        if not self.obs.enabled:
            return self.executor.run(self.task, self.global_params, requests,
                                     lr=self.cfg.lr, batch_size=self.cfg.local_batch,
                                     prox_mu=self.cfg.prox_mu)
        # profiled path: fence the result so device work is charged to this
        # executor call rather than the next host sync
        t0 = time.perf_counter()
        out = self.executor.run(self.task, self.global_params, requests,
                                lr=self.cfg.lr, batch_size=self.cfg.local_batch,
                                prox_mu=self.cfg.prox_mu)
        _profiling.fence(out.params)
        self.obs.record_op(f"executor.{self._executor_label}",
                           time.perf_counter() - t0)
        return out

    def _check_available(self, ctx: RoundContext, ids: np.ndarray,
                         policy: SelectionPolicy, stage: str) -> None:
        """Fail fast when a policy schedules work on an offline device."""
        offline = ids[~ctx.available[ids]]
        if len(offline):
            raise ValueError(
                f"policy {policy.name!r} {stage} offline devices "
                f"{offline.tolist()} (RoundContext.available must be respected)")

    # ------------------------------------------------------------------
    def run_round(self, policy: SelectionPolicy) -> RoundResult:
        if self.topology is not None:
            from repro_torch.fl.topology import run_topology_round

            return run_topology_round(self, policy)
        cfg = self.cfg
        obs = self.obs
        t_host0 = time.perf_counter()
        with obs.span("context"):
            self.pool.advance_round()
            ctx = self._ctx()
            self.loss_age += 1

        with obs.span("plan"):
            plan = build_round_plan(policy, ctx, cfg.l_ep)
        probe_ids = np.asarray(plan.probe_ids, dtype=np.int64)
        probe_states = None
        probe_params: Dict[int, Params] = {}

        # ---- probe stage ---------------------------------------------
        if plan.has_probe:
            with obs.span("probe"):
                self._check_available(ctx, probe_ids, policy, "probed")
                with obs.span("requests"):
                    reqs = build_requests(probe_ids, self._client_data,
                                          plan.probe_epochs, seed=cfg.seed,
                                          round_idx=ctx.round,
                                          stride=PROBE_SEED_STRIDE)
                probed = self._execute(reqs)
                probe_params = probed.params
                probe_losses = np.array([probed.losses[int(i)][-1]
                                         for i in probe_ids])
                self.last_loss[probe_ids] = probe_losses
                self.loss_age[probe_ids] = 0
                probe_states = ctx.probe_states(probe_ids, probe_losses)

        # ---- select (+ the scenario failure draw) --------------------
        with obs.span("select"):
            selected = np.asarray(policy.select(
                ctx, probe_ids if plan.has_probe else None, probe_states),
                dtype=np.int64)
            self._check_available(ctx, selected, policy, "selected")
            if plan.has_probe:
                missing = [int(i) for i in selected if int(i) not in probe_params]
                if missing:
                    raise ValueError(
                        f"policy {policy.name!r} selected devices {missing} "
                        "outside the round's probe set")
            # drawn before execution: who drops or misses the deadline is
            # simulated, so the server never runs (or aggregates) their work
            completion_s = (ctx.sys.t_comm[selected]
                            + ctx.sys.t_comp[selected] * plan.completion_epochs)
            outcome = self.pool.draw_failures(self.rng, selected, completion_s)
            lost = set(int(i) for i in outcome.lost)
            survivors = np.asarray([i for i in selected if int(i) not in lost],
                                   dtype=np.int64)

        # ---- completion stage (survivors only) -----------------------
        with obs.span("complete"):
            if plan.completion_epochs > 0 and len(survivors):
                with obs.span("requests"):
                    reqs = build_requests(survivors, self._client_data,
                                          plan.completion_epochs, seed=cfg.seed,
                                          round_idx=ctx.round,
                                          stride=COMPLETE_SEED_STRIDE,
                                          init_params=probe_params)
                completed = self._execute(reqs)
                client_results: Dict[int, Params] = dict(completed.params)
                # losses from survivors only: a lost device never uploaded
                for i in survivors:
                    losses = completed.losses[int(i)]
                    if len(losses):
                        self.last_loss[i] = losses[-1]
                        self.loss_age[i] = 0
            else:
                # no completion stage (l_ep == probe_epochs): probed params
                # final
                client_results = {int(i): probe_params[int(i)] for i in survivors
                                  if int(i) in probe_params}

        # stragglers' cost is sunk up to the round deadline; Bernoulli
        # failures are charged in full
        r_t = plan_round_latency(ctx.sys, probe_ids, selected,
                                 plan.probe_epochs, plan.completion_epochs,
                                 deadline_s=outcome.deadline_s)
        r_e = plan_round_energy(ctx.sys, probe_ids, selected,
                                plan.probe_epochs, plan.completion_epochs,
                                deadline_s=outcome.deadline_s)

        # ---- attack injection (after training, before aggregation) ---
        # adversarial survivors upload corrupted params, relative to the
        # dispatch-time global model, from the attack's own RNG stream
        with obs.span("aggregate"):
            adversaries = _empty_ids()
            if self.attack is not None and len(selected):
                adv = self.attack.draw(cfg.n_devices, cfg.seed, ctx.round,
                                       selected)
                adversaries = selected[adv]
                for i in adversaries:
                    if int(i) in client_results:
                        client_results[int(i)] = self.attack.corrupt(
                            client_results[int(i)], self.global_params,
                            cid=int(i), seed=cfg.seed, round_idx=ctx.round)

            if client_results:
                weights = [self.data_sizes[i] for i in client_results]
                self.global_params = robust_aggregate(
                    list(client_results.values()), weights, kind=cfg.aggregator,
                    trim=cfg.agg_trim, f=cfg.agg_f, m_select=cfg.agg_m or None)

        # ---- telemetry (deterministic: recording never perturbs a run) ---
        with obs.span("telemetry"):
            tel = self.telemetry
            tel.observe_availability(ctx.available)
            tel.observe_selection(selected)
            tel.observe_dropouts(outcome.failed)
            tel.observe_stragglers(outcome.stragglers)
            if len(survivors):
                # probe BARRIER (selection waits on the whole probe cohort)
                # + comms + completion compute
                barrier = (float(ctx.sys.t_comp[probe_ids].max())
                           * plan.probe_epochs if plan.has_probe else 0.0)
                dur = (barrier + ctx.sys.t_comm[survivors]
                       + ctx.sys.t_comp[survivors] * plan.completion_epochs)
                tel.observe_completions(survivors, dur)
                # synchronous merges land immediately: version lag 0
                tel.observe_staleness(survivors, np.zeros(len(survivors)))
            tel.observe_cadence(r_t)

        acc, test_loss = self._evaluate()
        d_acc = acc - self._last_acc
        self._last_acc = acc
        reward = paper_reward(d_acc, r_t, r_e, self.t_budget, self.e_budget,
                              cfg.alpha, cfg.beta)
        self._cum_time += r_t
        self._cum_energy += r_e
        result = RoundResult(
            round=ctx.round, selected=selected, probe_set=probe_ids, acc=acc,
            test_loss=test_loss, r_t=r_t, r_e=r_e, d_acc=d_acc, reward=reward,
            cum_time=self._cum_time, cum_energy=self._cum_energy,
            failed=outcome.failed, stragglers=outcome.stragglers,
            adversaries=adversaries, n_available=int(ctx.available.sum()),
            executor=self._executor_label)
        self.history.append(result)
        with obs.span("observe"):
            policy.observe(ctx, result, probe_ids if plan.has_probe else None,
                           probe_states)
        result.host_time_s = time.perf_counter() - t_host0
        if obs.enabled:
            m = obs.metrics
            m.gauge("devices_online", result.n_available)
            m.gauge("n_selected", len(selected))
            m.count("failures", len(outcome.failed))
            m.count("stragglers", len(outcome.stragglers))
            m.count("adversaries_merged", len(adversaries))
            obs.flush_round(round=result.round, mode="sync",
                            host_time_s=result.host_time_s,
                            executor=result.executor,
                            virtual_time_s=result.cum_time, r_t=result.r_t,
                            acc=result.acc)
        return result

    def run_async(self, policy: SelectionPolicy,
                  aggregations: Optional[int] = None,
                  verbose: bool = False) -> List[RoundResult]:
        """Asynchronous regime: the event loop over the scenario's
        availability windows with buffered, staleness-weighted aggregation
        (:mod:`repro_torch.fl.async_engine`).  Runs until ``aggregations``
        (default ``cfg.rounds``) buffer merges; each appends one
        :class:`RoundResult` whose ``cum_time`` is the absolute virtual
        clock."""
        from repro_torch.fl.async_engine import AsyncRoundEngine

        if self.topology is not None:
            from repro_torch.fl.topology import HierarchicalAsyncEngine

            engine = HierarchicalAsyncEngine(self, policy)
        else:
            engine = AsyncRoundEngine(self, policy)
        engine.run(aggregations or self.cfg.rounds, verbose=verbose)
        return self.history

    @property
    def is_async(self) -> bool:
        """``mode="async"`` — or the ``"async"`` executor-registry alias."""
        return self.cfg.mode == "async" or self.cfg.executor == "async"

    def run(self, policy: SelectionPolicy, rounds: Optional[int] = None,
            verbose: bool = False) -> List[RoundResult]:
        if self.is_async:
            return self.run_async(policy, aggregations=rounds, verbose=verbose)
        for _ in range(rounds or self.cfg.rounds):
            res = self.run_round(policy)
            self.log.log("round", force=verbose, policy=policy.name,
                         round=res.round, acc=res.acc, r_t_s=res.r_t,
                         r_e_j=res.r_e, reward=res.reward,
                         host_s=res.host_time_s)
        return self.history
