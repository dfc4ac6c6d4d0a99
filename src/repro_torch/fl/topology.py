"""Hierarchical aggregation topology: edge and regional tiers over the fleet.

Production FL at fleet scale is not one flat server: devices report to a
nearby *edge* aggregator, edges fold into regional tiers, and only region
deltas cross the backbone to the global root (HierFAVG).  This module puts
that regime on top of the existing engines, as the reference does:

* :class:`AggregationTopology` — a tree of named tiers: leaf *regions* (one
  per :class:`~repro_torch.fl.simulation.DevicePool` region label, in label
  order) through zero or more intermediate :class:`TierSpec` tiers to an
  implicit global root.  Each leaf carries a selection budget ``k_r``
  (``FLConfig.region_budgets``, or an even split of ``k_select``).
* :func:`run_topology_round` — the synchronous hierarchical round: every
  region runs its own probe -> select -> complete plan over its device slice
  under its own budget (FedRank's ``probe_set`` and ``select`` are a
  ``select_topk`` launch each, per region), client updates fold into one
  region delta per leaf, and the deltas fold tier by tier into the root via
  :func:`~repro_torch.fl.aggregation.buffered_aggregate`.  Region cohorts
  are *stacked* into one executor call per stage (``FLConfig.region_exec=
  "stacked"``, the path that batches every region's clients into one
  vmapped step); ``"sequential"`` runs one call per region, with identical
  results.
* :class:`HierarchicalAsyncEngine` — the buffered asynchronous regime over
  the same tree: per-region dispatch waves (round-robin, each capped at
  ``k_r``), per-region buffers that fold into :class:`RegionDelta` edge
  merges, and a root that merges every ``root_fanin`` deltas.  Staleness is
  accounted per tier: the effective coefficient composes the region lag and
  the root lag (:func:`~repro_torch.fl.aggregation.compose_staleness`), and
  each :class:`~repro_torch.fl.server.RoundResult` reports the per-tier
  means in ``tier_staleness``.

Reduction anchor: a single-region topology IS the flat engine.  The sync
driver replays :meth:`FLServer.run_round`'s operation and RNG order, and a
fold at lag 0 weighs exactly 1, so it is bit for bit FedAvg; the async
engine degenerates to :class:`~repro_torch.fl.async_engine.AsyncRoundEngine`.

Unlike the reference, no observability spans or metrics (they come with the
observability slice).
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.fl.aggregation import (
    buffered_aggregate,
    compose_staleness,
    robust_aggregate,
)
from repro_torch.fl.async_engine import AsyncRoundEngine
from repro_torch.fl.engine import (
    COMPLETE_SEED_STRIDE,
    PROBE_SEED_STRIDE,
    build_requests,
    build_round_plan,
)
from repro_torch.fl.simulation import plan_round_energy, plan_round_latency

Params = Any


# ---------------------------------------------------------------------------
# Topology tree
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TierSpec:
    """One intermediate aggregation tier: merges its named children (leaf
    regions or lower tiers) into a single delta.  Tiers are declared
    bottom-up; anything no tier claims reports directly to the root."""

    name: str
    children: Tuple[str, ...]


@dataclass(frozen=True)
class AggregationTopology:
    """A tree of named aggregation tiers over a regioned fleet.

    ``leaves`` are the region names in :class:`DevicePool` label order
    (leaf i aggregates the devices with ``pool.region == i``).  ``tiers``
    are optional intermediate folds, bottom-up; the global root merges
    every node left unclaimed.  ``budgets`` optionally pins per-leaf
    selection budgets ``k_r`` (default: an even split of ``k_select`` —
    see :meth:`resolve_budgets`).  ``root_fanin`` is the asynchronous
    root's merge batch (region deltas per root merge; default
    ``max(1, n_regions - 1)`` so the root never waits for the slowest
    region and late deltas land with a nonzero root lag)."""

    leaves: Tuple[str, ...]
    tiers: Tuple[TierSpec, ...] = ()
    budgets: Optional[Tuple[int, ...]] = None
    root_fanin: Optional[int] = None

    def __post_init__(self):
        if not self.leaves:
            raise ValueError("a topology needs at least one leaf region")
        if len(set(self.leaves)) != len(self.leaves):
            raise ValueError(f"duplicate leaf names in {self.leaves}")
        known = set(self.leaves)
        claimed: set = set()
        for tier in self.tiers:
            if tier.name in known:
                raise ValueError(f"tier name {tier.name!r} already used")
            if not tier.children:
                raise ValueError(f"tier {tier.name!r} has no children")
            for child in tier.children:
                if child not in known:
                    raise ValueError(
                        f"tier {tier.name!r} child {child!r} is neither a "
                        "leaf nor an earlier tier (declare tiers bottom-up)")
                if child in claimed:
                    raise ValueError(f"node {child!r} has two parents")
                claimed.add(child)
            known.add(tier.name)
        if self.budgets is not None and len(self.budgets) != len(self.leaves):
            raise ValueError(f"{len(self.budgets)} budgets for "
                             f"{len(self.leaves)} leaves")

    @property
    def n_regions(self) -> int:
        return len(self.leaves)

    def root_children(self) -> Tuple[str, ...]:
        """Nodes (leaves or tiers) merged directly by the global root."""
        claimed = {c for t in self.tiers for c in t.children}
        return tuple(n for n in (*self.leaves, *(t.name for t in self.tiers))
                     if n not in claimed)

    def tier_path(self, leaf: str) -> Tuple[str, ...]:
        """Tier names an update from ``leaf`` crosses, bottom-up, ending at
        the implicit ``"root"``."""
        path, node = [], leaf
        parent = {c: t.name for t in self.tiers for c in t.children}
        while node in parent:
            node = parent[node]
            path.append(node)
        return (*path, "root")

    def resolve_budgets(self, k_select: int, overrides=None) -> np.ndarray:
        """Per-leaf selection budgets ``k_r``, in leaf order.  Precedence:
        ``overrides`` (``FLConfig.region_budgets``: dict name -> k, or a
        sequence in leaf order) > the topology's own ``budgets`` > an even
        split of ``k_select`` (remainder to the first leaves)."""
        n = self.n_regions
        budgets = overrides if overrides is not None else self.budgets
        if budgets is not None:
            if isinstance(budgets, dict):
                missing = set(self.leaves) - set(budgets)
                if missing:
                    raise ValueError(f"region_budgets missing {sorted(missing)}")
                arr = np.array([int(budgets[l]) for l in self.leaves],
                               dtype=np.int64)
            else:
                arr = np.asarray(list(budgets), dtype=np.int64)
                if len(arr) != n:
                    raise ValueError(f"{len(arr)} region budgets for "
                                     f"{n} regions")
            if (arr < 0).any():
                raise ValueError(f"negative region budget in {arr.tolist()}")
            return arr
        base, rem = divmod(int(k_select), n)
        out = np.full(n, base, dtype=np.int64)
        out[:rem] += 1
        return out


def flat_topology(region_name: str = "region0") -> AggregationTopology:
    """The degenerate single-region topology — routes a flat fleet through
    the hierarchical drivers (bit-for-bit the plain engines)."""
    return AggregationTopology(leaves=(region_name,))


def regions_topology(region_names: Sequence[str]) -> AggregationTopology:
    """One leaf per pool region, all direct children of the root — the
    default tree for any regioned scenario."""
    return AggregationTopology(leaves=tuple(region_names))


# ---------------------------------------------------------------------------
# Topology registry (mirrors the scenario/policy registries)
# ---------------------------------------------------------------------------

# factories take the DevicePool so a named topology can adapt to (and
# validate against) the fleet's declared regions
_TOPOLOGIES: Dict[str, Callable[..., AggregationTopology]] = {}


def register_topology(name: str,
                      factory: Callable[..., AggregationTopology]) -> None:
    """Register a named topology factory ``(pool) -> AggregationTopology``."""
    if name in _TOPOLOGIES:
        raise ValueError(f"topology {name!r} already registered")
    _TOPOLOGIES[name] = factory


def get_topology(name: str, pool) -> AggregationTopology:
    try:
        factory = _TOPOLOGIES[name]
    except KeyError:
        raise KeyError(f"unknown topology {name!r}; "
                       f"registered: {available_topologies()}") from None
    return factory(pool)


def available_topologies() -> List[str]:
    return sorted(_TOPOLOGIES)


def _flat_factory(pool) -> AggregationTopology:
    if pool.n_regions != 1:
        raise ValueError(
            f"topology 'flat' needs an unregioned fleet, got "
            f"{pool.n_regions} regions — use 'regions' or an explicit tree")
    return flat_topology(pool.region_names[0])


def _edge_hier_factory(pool) -> AggregationTopology:
    """Three-tier tree for the ``hierarchical`` scenario: the metro and
    suburban leaves fold at an ``edge`` tier before crossing the backbone;
    the rural leaf reports straight to the root."""
    want = ("metro", "suburban", "rural")
    if tuple(pool.region_names) != want:
        raise ValueError(
            f"topology 'edge-hier' expects regions {want} (the "
            f"'hierarchical' scenario), got {tuple(pool.region_names)}")
    return AggregationTopology(
        leaves=want,
        tiers=(TierSpec(name="edge", children=("metro", "suburban")),))


register_topology("flat", _flat_factory)
register_topology("regions", lambda pool: regions_topology(pool.region_names))
register_topology("edge-hier", _edge_hier_factory)


def resolve_topology(cfg, pool) -> Optional[AggregationTopology]:
    """``FLConfig.topology`` -> the round drivers' topology (or None = the
    untouched flat path).  ``None`` auto-builds the default region tree
    when the fleet declares regions; an explicit name or
    :class:`AggregationTopology` is honored (and validated) even for a
    single-region fleet — that is how the parity tests force the
    hierarchical drivers onto a flat run."""
    topo = getattr(cfg, "topology", None)
    if topo is None:
        if pool.n_regions > 1:
            return regions_topology(pool.region_names)
        return None
    if isinstance(topo, str):
        topo = get_topology(topo, pool)
    if not isinstance(topo, AggregationTopology):
        raise TypeError(f"FLConfig.topology must be a registered name or an "
                        f"AggregationTopology, got {type(topo).__name__}")
    if topo.n_regions != pool.n_regions:
        raise ValueError(
            f"topology has {topo.n_regions} leaves but the fleet declares "
            f"{pool.n_regions} regions")
    return topo


# ---------------------------------------------------------------------------
# Tier folding
# ---------------------------------------------------------------------------


def fold_topology(topo: AggregationTopology, global_params: Params,
                  deltas: Dict[str, Tuple[Params, float]],
                  lags: Optional[Dict[str, float]] = None, *,
                  kind: str = "constant", a: float = 0.5, b: int = 4,
                  robust: str = "mean", trim: int = 1, f: int = 1,
                  m_select: Optional[int] = None) -> Params:
    """Fold per-leaf deltas ``{leaf: (params, weight)}`` up the tree into a
    new global model.  Each tier (and the root) merges its present children
    with :func:`buffered_aggregate` — weights are the children's total data
    mass, lags per node from ``lags`` (default 0, where every staleness
    kind weighs exactly 1, the flat-parity anchor).  Absent leaves (offline
    or empty regions) are skipped; their tiers fold whatever arrived.

    A non-``"mean"`` ``robust`` kind makes every tier fold Byzantine-robust
    (a compromised *region* is out-voted at its parent tier the same way a
    compromised client is out-voted at the edge); the default keeps each
    fold bit-for-bit the staleness-weighted mean."""
    lags = lags or {}
    nodes = dict(deltas)
    for tier in topo.tiers:
        kids = [c for c in tier.children if c in nodes]
        if not kids:
            continue
        ps, ws = zip(*(nodes.pop(c) for c in kids))
        merged = buffered_aggregate(
            global_params, list(ps), list(ws),
            [lags.get(c, 0) for c in kids], kind=kind, a=a, b=b,
            robust=robust, trim=trim, f=f, m_select=m_select)
        nodes[tier.name] = (merged, float(sum(ws)))
    kids = [c for c in (*topo.leaves, *(t.name for t in topo.tiers))
            if c in nodes]
    if not kids:
        return global_params
    ps, ws = zip(*(nodes[c] for c in kids))
    return buffered_aggregate(global_params, list(ps), list(ws),
                              [lags.get(c, 0) for c in kids],
                              kind=kind, a=a, b=b,
                              robust=robust, trim=trim, f=f,
                              m_select=m_select)


# ---------------------------------------------------------------------------
# Synchronous hierarchical round
# ---------------------------------------------------------------------------


def _execute_grouped(srv, groups: Sequence[Sequence], mode: str):
    """Run per-region request lists through the server's executor: one
    stacked call over the concatenated cohort (one batched step per bucket
    under the vmapped executor) or one call per region.  Executors are
    per-request deterministic, so both modes produce identical results."""
    params: Dict[int, Params] = {}
    losses: Dict[int, np.ndarray] = {}
    if mode == "sequential":
        for reqs in groups:
            if not reqs:
                continue
            res = srv._execute(reqs)
            params.update(res.params)
            losses.update(res.losses)
    elif mode == "stacked":
        flat = [q for reqs in groups for q in reqs]
        if flat:
            res = srv._execute(flat)
            params.update(res.params)
            losses.update(res.losses)
    else:
        raise ValueError(f"unknown region_exec {mode!r}; "
                         "expected 'stacked' or 'sequential'")
    return params, losses


def run_topology_round(srv, policy):
    """One synchronous hierarchical round over ``srv.topology``.

    Per region (leaf order): its own probe draw, selection under its budget
    ``k_r``, and failure draw — exactly the flat engine's operation and RNG
    order, restricted to the region's available slice.  Client work is
    executed in ONE stacked call per stage across all regions
    (``cfg.region_exec``), region cohorts fold to per-leaf deltas, and the
    deltas fold up the tier tree (all at lag 0: synchronous merges are
    fresh).  Round latency is the max over regions (regions run in
    parallel), energy the sum.  With a single-region topology every step
    reduces bit-for-bit to :meth:`FLServer.run_round`."""
    from repro_torch.fl.server import RoundResult, paper_reward

    cfg, topo = srv.cfg, srv.topology
    obs = srv.obs
    t_host0 = time.perf_counter()
    srv.pool.advance_round()
    base_ctx = srv._ctx()
    srv.loss_age += 1
    budgets = topo.resolve_budgets(cfg.k_select, cfg.region_budgets)
    labels = srv.pool.region

    # ---- per-region plans (probe draws in leaf order) ----------------
    regions: List[dict] = []
    with obs.span("plan"):
        for r, name in enumerate(topo.leaves):
            avail_r = base_ctx.available & (labels == r)
            if budgets[r] <= 0 or not avail_r.any():
                continue        # dark or unbudgeted region: skipped, no RNG
            ctx_r = dataclasses.replace(base_ctx, k=int(budgets[r]),
                                        available=avail_r,
                                        region_id=r, region_name=name)
            plan = build_round_plan(policy, ctx_r, cfg.l_ep)
            regions.append({
                "name": name, "ctx": ctx_r, "plan": plan,
                "probe_ids": np.asarray(plan.probe_ids, dtype=np.int64),
                "probe_states": None,
            })

    # ---- probe stage (one stacked executor call) ---------------------
    probing = [g for g in regions if g["plan"].has_probe]
    probe_params: Dict[int, Params] = {}
    for g in probing:
        srv._check_available(g["ctx"], g["probe_ids"], policy, "probed")
    if probing:
        with obs.span("probe"):
            groups = [build_requests(g["probe_ids"], srv._client_data,
                                     g["plan"].probe_epochs, seed=cfg.seed,
                                     round_idx=base_ctx.round,
                                     stride=PROBE_SEED_STRIDE)
                      for g in probing]
            probe_params, probe_losses = _execute_grouped(srv, groups,
                                                          cfg.region_exec)
            for g in probing:
                pl = np.array([probe_losses[int(i)][-1]
                               for i in g["probe_ids"]])
                srv.last_loss[g["probe_ids"]] = pl
                srv.loss_age[g["probe_ids"]] = 0
                g["probe_states"] = g["ctx"].probe_states(g["probe_ids"], pl)

    # ---- select + failure draw (leaf order, one draw per region) -----
    with obs.span("select"):
        for g in regions:
            ctx_r, plan = g["ctx"], g["plan"]
            selected = np.asarray(policy.select(
                ctx_r, g["probe_ids"] if plan.has_probe else None,
                g["probe_states"]), dtype=np.int64)
            if len(selected) > ctx_r.k:
                raise ValueError(
                    f"policy {policy.name!r} selected {len(selected)} devices in "
                    f"region {g['name']!r}, exceeding its budget k_r={ctx_r.k}")
            srv._check_available(ctx_r, selected, policy, "selected")
            if plan.has_probe:
                missing = [int(i) for i in selected
                           if int(i) not in probe_params]
                if missing:
                    raise ValueError(
                        f"policy {policy.name!r} selected devices {missing} "
                        "outside the round's probe set")
            completion_s = (ctx_r.sys.t_comm[selected]
                            + ctx_r.sys.t_comp[selected] * plan.completion_epochs)
            outcome = srv.pool.draw_failures(srv.rng, selected, completion_s)
            lost = set(int(i) for i in outcome.lost)
            g["selected"] = selected
            g["outcome"] = outcome
            g["survivors"] = np.asarray(
                [i for i in selected if int(i) not in lost], dtype=np.int64)

    # ---- completion stage (one stacked executor call) ----------------
    with obs.span("complete"):
        groups = [build_requests(g["survivors"], srv._client_data,
                                 g["plan"].completion_epochs, seed=cfg.seed,
                                 round_idx=base_ctx.round,
                                 stride=COMPLETE_SEED_STRIDE,
                                 init_params=probe_params)
                  if g["plan"].completion_epochs > 0 and len(g["survivors"])
                  else [] for g in regions]
        comp_params, comp_losses = _execute_grouped(srv, groups,
                                                    cfg.region_exec)
        for g in regions:
            if g["plan"].completion_epochs > 0 and len(g["survivors"]):
                g["client_results"] = {int(i): comp_params[int(i)]
                                       for i in g["survivors"]}
                for i in g["survivors"]:
                    ls = comp_losses[int(i)]
                    if len(ls):
                        srv.last_loss[i] = ls[-1]
                        srv.loss_age[i] = 0
            else:
                g["client_results"] = {int(i): probe_params[int(i)]
                                       for i in g["survivors"]
                                       if int(i) in probe_params}

    # ---- attack injection (per region, before the edge fold) ---------
    # same contract as the flat engine: adversarial survivors' uploads are
    # corrupted relative to the dispatch-time global model, keyed by
    # (seed, round, cid) through the dedicated attack RNG stream — the
    # per-region draw is a pure gather of the static adversary mask, so a
    # single-region topology replays the flat engine's draw exactly
    for g in regions:
        g["adversaries"] = np.empty(0, dtype=np.int64)
        if srv.attack is not None and len(g["selected"]):
            adv = srv.attack.draw(cfg.n_devices, cfg.seed, base_ctx.round,
                                  g["selected"])
            g["adversaries"] = g["selected"][adv]
            for i in g["adversaries"]:
                if int(i) in g["client_results"]:
                    g["client_results"][int(i)] = srv.attack.corrupt(
                        g["client_results"][int(i)], srv.global_params,
                        cid=int(i), seed=cfg.seed, round_idx=base_ctx.round)

    # ---- per-region accounting; regions run in parallel --------------
    for g in regions:
        ctx_r, plan = g["ctx"], g["plan"]
        g["r_t"] = plan_round_latency(ctx_r.sys, g["probe_ids"],
                                      g["selected"], plan.probe_epochs,
                                      plan.completion_epochs,
                                      deadline_s=g["outcome"].deadline_s)
        g["r_e"] = plan_round_energy(ctx_r.sys, g["probe_ids"],
                                     g["selected"], plan.probe_epochs,
                                     plan.completion_epochs,
                                     deadline_s=g["outcome"].deadline_s)
    r_t = max((g["r_t"] for g in regions), default=0.0)
    r_e = sum(g["r_e"] for g in regions)

    # ---- fold: clients -> region deltas -> tiers -> root -------------
    # the edge fold is where robust aggregation bites: adversarial clients
    # are out-voted inside their region before the delta crosses the tree
    # (aggregator="mean" keeps robust_aggregate == fedavg bit-for-bit)
    with obs.span("aggregate"):
        deltas: Dict[str, Tuple[Params, float]] = {}
        for g in regions:
            if g["client_results"]:
                ws = [srv.data_sizes[i] for i in g["client_results"]]
                deltas[g["name"]] = (
                    robust_aggregate(list(g["client_results"].values()), ws,
                                     kind=cfg.aggregator, trim=cfg.agg_trim,
                                     f=cfg.agg_f, m_select=cfg.agg_m or None),
                    float(sum(ws)))
        if deltas:
            srv.global_params = fold_topology(
                topo, srv.global_params, deltas, kind=cfg.staleness,
                a=cfg.staleness_a, b=cfg.staleness_b, robust=cfg.aggregator,
                trim=cfg.agg_trim, f=cfg.agg_f, m_select=cfg.agg_m or None)

    # ---- telemetry (flat engine's feed order, concatenated) ----------
    def _concat(key):
        parts = [g[key] for g in regions]
        return (np.concatenate(parts).astype(np.int64) if parts
                else np.empty(0, dtype=np.int64))

    all_probe = (np.concatenate([g["probe_ids"] for g in probing])
                 if probing else np.empty(0, dtype=np.int64))
    all_selected = _concat("selected")
    all_failed = (np.concatenate([g["outcome"].failed for g in regions])
                  if regions else np.empty(0, dtype=np.int64))
    all_strag = (np.concatenate([g["outcome"].stragglers for g in regions])
                 if regions else np.empty(0, dtype=np.int64))
    all_survivors = _concat("survivors")

    with obs.span("telemetry"):
        tel = srv.telemetry
        tel.observe_availability(base_ctx.available)
        tel.observe_selection(all_selected)
        tel.observe_dropouts(all_failed)
        tel.observe_stragglers(all_strag)
        if len(all_survivors):
            durs = []
            for g in regions:
                sys_r, plan = g["ctx"].sys, g["plan"]
                barrier = (float(sys_r.t_comp[g["probe_ids"]].max())
                           * plan.probe_epochs if plan.has_probe else 0.0)
                durs.append(barrier + sys_r.t_comm[g["survivors"]]
                            + sys_r.t_comp[g["survivors"]]
                            * plan.completion_epochs)
            tel.observe_completions(all_survivors, np.concatenate(durs))
            tel.observe_staleness(all_survivors,
                                  np.zeros(len(all_survivors)))
        tel.observe_cadence(r_t)

    # ---- evaluate + record -------------------------------------------
    acc, test_loss = srv._evaluate()
    d_acc = acc - srv._last_acc
    srv._last_acc = acc
    reward = paper_reward(d_acc, r_t, r_e, srv.t_budget, srv.e_budget,
                          cfg.alpha, cfg.beta)
    srv._cum_time += r_t
    srv._cum_energy += r_e
    # synchronous merges are fresh at every tier: lag 0 regionally and at
    # the root, reported so downstream reductions see the tier structure
    tier_staleness = {f"region:{name}": 0.0 for name in deltas}
    if deltas:
        tier_staleness.update({t.name: 0.0 for t in topo.tiers})
        tier_staleness["root"] = 0.0
    result = RoundResult(
        round=base_ctx.round, selected=all_selected, probe_set=all_probe,
        acc=acc, test_loss=test_loss, r_t=r_t, r_e=r_e, d_acc=d_acc,
        reward=reward, cum_time=srv._cum_time, cum_energy=srv._cum_energy,
        failed=all_failed, stragglers=all_strag,
        adversaries=_concat("adversaries"),
        n_available=int(base_ctx.available.sum()),
        tier_staleness=tier_staleness,
        executor=srv._executor_label)
    srv.history.append(result)
    all_states = (np.vstack([g["probe_states"] for g in probing])
                  if probing else None)
    with obs.span("observe"):
        policy.observe(base_ctx, result, all_probe if probing else None,
                       all_states)
    result.host_time_s = time.perf_counter() - t_host0
    if obs.enabled:
        m = obs.metrics
        m.gauge("devices_online", result.n_available)
        m.gauge("n_selected", len(all_selected))
        m.gauge("n_regions", len(regions))
        m.count("failures", len(all_failed))
        m.count("adversaries_merged", len(result.adversaries))
        for tier, lag in tier_staleness.items():
            m.gauge(f"tier_lag.{tier}", lag)
        obs.flush_round(round=result.round, mode="sync",
                        host_time_s=result.host_time_s,
                        executor=result.executor,
                        virtual_time_s=result.cum_time, r_t=result.r_t,
                        acc=result.acc)
    return result


# ---------------------------------------------------------------------------
# Asynchronous hierarchical engine
# ---------------------------------------------------------------------------


@dataclass
class RegionDelta:
    """One region's edge merge, waiting in the root buffer."""

    name: str                 # leaf region name
    params: Params            # region-merged model
    weight: float             # total data mass of the merged clients
    version: int              # global version at the region merge
    seq: int                  # region-merge order (stable root merge order)
    cids: np.ndarray          # merged client ids
    client_lags: np.ndarray   # per-client REGION-tier version lags
    adversaries: np.ndarray = field(default_factory=lambda: np.empty(
        0, dtype=np.int64))   # merged clients flagged by the attack model


class HierarchicalAsyncEngine(AsyncRoundEngine):
    """Buffered asynchronous aggregation over an
    :class:`AggregationTopology`.

    Dispatch walks the regions round-robin, one wave per region capped at
    its budget ``k_r``; completed updates drain into per-region buffers
    sized proportionally to the budgets.  A full region buffer folds at
    the edge into a :class:`RegionDelta` (clients weighted by data size x
    staleness of their *region lag*), and the root merges every
    ``root_fanin`` deltas (weighted by region mass x staleness of the
    *root lag*) — so a client's effective coefficient composes
    ``s(region_lag) * s(root_lag)`` exactly as
    :func:`~repro_torch.fl.aggregation.compose_staleness` predicts, and each
    root merge's :class:`~repro_torch.fl.server.RoundResult` carries the
    per-tier means in ``tier_staleness``.

    The asynchronous regime folds leaves straight into the root (the two
    tiers whose lags compose); intermediate :class:`TierSpec` tiers only
    shape the synchronous fold.

    With one region this is bit-for-bit the base engine: one region buffer
    of ``buffer_size``, fan-in 1, root lag always 0."""

    def __init__(self, server, policy):
        super().__init__(server, policy)
        cfg = server.cfg
        self.topo: AggregationTopology = server.topology
        self.budgets = self.topo.resolve_budgets(cfg.k_select,
                                                 cfg.region_budgets)
        self.region_labels = server.pool.region
        n_regions = self.topo.n_regions
        region_sizes = np.bincount(self.region_labels, minlength=n_regions)
        # region buffer thresholds: the buffer splits proportionally to the
        # budgets (a single region inherits buffer_size exactly), capped at
        # the region's device count so small regions can still fold
        k_total = max(int(self.budgets.sum()), 1)
        self.region_buffer_size = [
            max(1, min(int(round(self.buffer_size * int(b) / k_total)),
                       int(region_sizes[r]) or 1))
            for r, b in enumerate(self.budgets)]
        self.region_buffers: List[List] = [[] for _ in range(n_regions)]
        self.root_buffer: List[RegionDelta] = []
        active = int((self.budgets > 0).sum()) or 1
        fanin = (self.topo.root_fanin if self.topo.root_fanin is not None
                 else max(1, n_regions - 1))
        self.fanin = max(1, min(int(fanin), active))
        self._cursor = 0          # round-robin region dispatch pointer
        self._delta_seq = 0

    # ------------------------------------------------------------------
    # dispatch: one wave per region, round-robin, capped at k_r
    # ------------------------------------------------------------------
    # NOTE: a device stays in the engine's incremental ``_busy`` mask and
    # its update keeps a concurrency slot until the ROOT merges it —
    # region-buffered jobs and folded-but-unmerged deltas included (the
    # same dispatch-until-merged semantics as the base engine).  Both are
    # maintained incrementally: set at dispatch, cleared in
    # :meth:`_aggregate` below — no per-wave buffer scans.

    def _dispatch(self) -> bool:
        srv, cfg = self.srv, self.srv.cfg
        if self._sync_pool():
            self.jobs.apply_mask(self._mask, self.now)
        free = self.concurrency - self._slots_used()
        if free <= 0:
            return False
        idle_online = self._idle_online()
        n_regions = self.topo.n_regions
        for step in range(n_regions):
            r = (self._cursor + step) % n_regions
            if self.budgets[r] <= 0:
                continue
            region_idle = idle_online & (self.region_labels == r)
            n_idle = int(region_idle.sum())
            if n_idle == 0:
                continue                 # dark/busy region: try the next
            k = min(free, n_idle, int(self.budgets[r]))
            ctx = srv._ctx(k=k, available=region_idle, round_idx=self.cycle)
            ctx.region_id = r
            ctx.region_name = self.topo.leaves[r]
            self._cursor = (r + 1) % n_regions
            return self._run_wave(ctx)
        return False

    # ------------------------------------------------------------------
    # merges: completed jobs -> region buffers -> edge deltas -> root
    # ------------------------------------------------------------------
    def _fill_need(self) -> np.ndarray:
        """Per-REGION completions remaining before an edge fold threshold
        fills (the batched event window must stop there: a fold can reach
        the root fan-in and trigger a merge).  Counts the not-yet-drained
        base buffer toward its regions."""
        fill = np.array([len(b) for b in self.region_buffers], np.int64)
        if self.buffer:
            np.add.at(fill, [int(self.region_labels[j.cid])
                             for j in self.buffer], 1)
        return np.asarray(self.region_buffer_size, np.int64) - fill

    def _fill_unit_of(self, cids: np.ndarray) -> np.ndarray:
        return np.asarray(self.region_labels[cids], np.int64)

    def _drain_to_regions(self) -> None:
        for job in self.buffer:
            self.region_buffers[int(self.region_labels[job.cid])].append(job)
        self.buffer = []

    def _fold_region(self, r: int) -> None:
        """Edge merge: fold the region's oldest ``region_buffer_size`` jobs
        into one :class:`RegionDelta` weighted by data size x staleness of
        each client's region lag."""
        cfg = self.srv.cfg
        buf = self.region_buffers[r]
        buf.sort(key=lambda j: j.seq)
        take, self.region_buffers[r] = (buf[:self.region_buffer_size[r]],
                                        buf[self.region_buffer_size[r]:])
        lags = np.array([self.version - j.version for j in take])
        weights = [float(self.srv.data_sizes[j.cid]) for j in take]
        params = buffered_aggregate(
            self.srv.global_params, [j.params for j in take], weights, lags,
            kind=cfg.staleness, a=cfg.staleness_a, b=cfg.staleness_b,
            robust=cfg.aggregator, trim=cfg.agg_trim, f=cfg.agg_f,
            m_select=cfg.agg_m or None)
        self.root_buffer.append(RegionDelta(
            name=self.topo.leaves[r], params=params,
            weight=float(sum(weights)), version=self.version,
            seq=self._delta_seq,
            cids=np.array([j.cid for j in take], dtype=np.int64),
            client_lags=lags,
            adversaries=np.array([j.cid for j in take if j.adversarial],
                                 dtype=np.int64)))
        self._delta_seq += 1

    def _ready(self) -> bool:
        # LAZY edge folding: fold only enough region deltas to reach the
        # root fan-in.  A region buffer left full waits for the next check —
        # by then a root merge may have bumped the version, so its clients'
        # region lags grow exactly as the base engine's buffer lags do (the
        # degenerate single-region case replays base lag accounting even
        # when several batches complete in one event tick)
        self._drain_to_regions()
        for r in range(self.topo.n_regions):
            while (len(self.root_buffer) < self.fanin
                   and len(self.region_buffers[r])
                   >= self.region_buffer_size[r]):
                self._fold_region(r)
            if len(self.root_buffer) >= self.fanin:
                break
        return len(self.root_buffer) >= self.fanin

    def _aggregate(self):
        """Root merge: apply the oldest ``fanin`` region deltas, each
        weighted by region mass x staleness of its root lag."""
        from repro_torch.fl.server import RoundResult, paper_reward

        srv, cfg = self.srv, self.srv.cfg
        self.root_buffer.sort(key=lambda d: d.seq)
        take, self.root_buffer = (self.root_buffer[:self.fanin],
                                  self.root_buffer[self.fanin:])
        root_lags = np.array([self.version - d.version for d in take])
        # the root fold stays a staleness-weighted mean: its inputs are
        # region deltas already robustly reduced at the edge (the tier with
        # client-level redundancy to vote over)
        srv.global_params = buffered_aggregate(
            srv.global_params, [d.params for d in take],
            [d.weight for d in take], root_lags,
            kind=cfg.staleness, a=cfg.staleness_a, b=cfg.staleness_b)
        self.version += 1

        # per-client TOTAL lag (region + root tiers compose; for one region
        # and fan-in 1 this is exactly the base engine's merge lag)
        cids = np.concatenate([d.cids for d in take])
        total_lags = np.concatenate(
            [d.client_lags + rl for d, rl in zip(take, root_lags)])
        srv.telemetry.observe_staleness(cids, total_lags)
        self.obs.metrics.observe("staleness", total_lags)
        self._busy[cids] = False         # root-merged: devices may work again
        self._upload_slots -= len(cids)

        acc, test_loss = srv._evaluate()
        d_acc = acc - srv._last_acc
        srv._last_acc = acc
        r_t = self.now - self._last_agg_t
        r_e = self._energy_since_agg
        reward = paper_reward(d_acc, r_t, r_e, srv.t_budget, srv.e_budget,
                              cfg.alpha, cfg.beta)
        srv._cum_time = self._time_offset + self.now
        per_region: Dict[str, List[float]] = {}
        for d in take:
            per_region.setdefault(d.name, []).extend(
                float(l) for l in d.client_lags)
        tier_staleness = {f"region:{name}": float(np.mean(lags))
                          for name, lags in per_region.items()}
        tier_staleness["root"] = float(root_lags.mean())
        result = RoundResult(
            round=len(srv.history), selected=cids,
            probe_set=np.empty(0, np.int64), acc=acc, test_loss=test_loss,
            r_t=r_t, r_e=r_e, d_acc=d_acc, reward=reward,
            cum_time=srv._cum_time, cum_energy=srv._cum_energy,
            failed=np.asarray(sorted(self._failed_since_agg), dtype=np.int64),
            adversaries=np.asarray(
                sorted(int(i) for d in take for i in d.adversaries),
                dtype=np.int64),
            n_available=int(self._mask.sum()),
            mean_staleness=float(total_lags.mean()),
            max_staleness=int(total_lags.max()),
            n_pending=len(self.jobs),
            tier_staleness=tier_staleness,
            executor=srv._executor_label)
        srv.history.append(result)
        srv.telemetry.observe_availability(self._mask)
        srv.telemetry.observe_cadence(r_t)
        self._last_agg_t = self.now
        self._energy_since_agg = 0.0
        self._failed_since_agg = []
        ctx, probe_ids, probe_states = self._last_observe
        if ctx is not None:
            self._last_observe = (None, None, None)
            self.policy.observe(ctx, result, probe_ids, probe_states)
        return result

    def _merge_metrics(self, m) -> None:
        """Per-region buffer fill + root fan-in level at each root merge:
        the gauges that answer "which region's buffer starved?"."""
        for r, buf in enumerate(self.region_buffers):
            m.gauge(f"region_buffer_fill.{self.topo.leaves[r]}", len(buf))
        m.gauge("root_buffer_fill", len(self.root_buffer))
