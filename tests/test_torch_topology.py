"""The port's regions and aggregation hierarchy against the JAX reference.

Exactly equal (numpy on the host in both packages): ``split_by_weight``, the
topology tree (``resolve_budgets``, ``tier_path``, ``root_children``), the
registry and its validation errors, ``resolve_topology``, and the pools of
the regioned scenarios (region labels, tiers, per-round availability and
loads over 20 rounds).

``fold_topology`` on the same region deltas: within 1e-6 (fp32 sums in
another order).

A synchronous hierarchical round on ``hierarchical`` (``fedavg``, and
``fedrank`` fed the reference's Q-net and server state before every round,
as in ``test_torch_slice``): per-region probe ids, cohorts, failures,
stragglers, latency, energy and ``tier_staleness`` exactly equal; global
params within 1e-5, the Q-net within 1e-4 (Adam's amplification of 1e-7
gradient noise, see ``test_torch_slice``).  ``region_exec="stacked"`` and
``"sequential"`` give bit-identical results; on ``regional-outage`` a dark
region is skipped, as in the reference.  ``HierarchicalAsyncEngine`` with
``fedavg``: every job, per-tier lag and ``tier_staleness`` exactly equal,
params within 1e-5.  Within the port, a forced single-region topology is
the flat run bit for bit.  Small sizes only: 30 devices, a 32 -> 32 -> 10
MLP.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fl as jfl
import repro.fl.scenarios as jscen
import repro.fl.topology as jtopo
import repro_torch.data as tdata
import repro_torch.fl as tfl
import repro_torch.fl.scenarios as tscen
import repro_torch.fl.topology as ttopo
from repro_torch.convert import params_from_numpy, params_to_numpy

N = 30


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _cpu(tree):
    return params_from_numpy(_np(tree), "cpu")


def _assert_close(ref, got, tol):
    ref, got = _np(ref), params_to_numpy(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def data30():
    from repro.data import FederatedData, dirichlet_partition, make_classification_data

    train, test = make_classification_data(n_samples=3000, seed=0)
    return FederatedData(train, test, dirichlet_partition(train.y, N, 0.1, seed=0))


def _tdata(d):
    return tdata.FederatedData(d.train, d.test, d.client_indices)


# ---------------------------------------------------------------------------
# the tree, the registry, the pools
# ---------------------------------------------------------------------------


def test_split_by_weight_equal():
    for n, w in ((30, [0.3, 0.4, 0.3]), (10, [1, 1, 1]), (7, [5, 1, 1, 0.01]),
                 (1000, [0.3, 0.4, 0.3]), (3, [1, 2, 3]), (11, [0.5, 0.5])):
        assert tscen.split_by_weight(n, w) == jscen.split_by_weight(n, w)
    with pytest.raises(ValueError, match="at least"):
        tscen.split_by_weight(2, [1, 1, 1])


def _raises_alike(jfn, tfn):
    """Both raise the same exception type with the same message."""
    with pytest.raises(Exception) as je:
        jfn()
    with pytest.raises(je.type) as te:
        tfn()
    assert str(te.value) == str(je.value)


BAD_TREES = [
    dict(leaves=()),
    dict(leaves=("a", "a")),
    dict(leaves=("a", "b"), tiers=(("a", ("b",)),)),
    dict(leaves=("a", "b"), tiers=(("t", ()),)),
    dict(leaves=("a", "b"), tiers=(("t", ("c",)),)),
    dict(leaves=("a", "b"), tiers=(("t", ("a",)), ("u", ("a", "b")))),
    dict(leaves=("a", "b"), budgets=(1,)),
]


def _tree(mod, leaves, tiers=(), **kw):
    return mod.AggregationTopology(
        leaves=leaves, tiers=tuple(mod.TierSpec(n, c) for n, c in tiers), **kw)


@pytest.mark.parametrize("bad", BAD_TREES)
def test_topology_validation_equal(bad):
    _raises_alike(lambda: _tree(jtopo, **bad), lambda: _tree(ttopo, **bad))


def test_topology_tree_equal():
    spec = dict(leaves=("a", "b", "c", "d"),
                tiers=(("e1", ("a", "b")), ("e2", ("e1", "c"))))
    jt, tt = _tree(jtopo, **spec), _tree(ttopo, **spec)
    assert tt.root_children() == jt.root_children() == ("d", "e2")
    for leaf in spec["leaves"]:
        assert tt.tier_path(leaf) == jt.tier_path(leaf)
    for k in (0, 1, 3, 4, 7, 10):
        np.testing.assert_array_equal(tt.resolve_budgets(k), jt.resolve_budgets(k))
    for over in ({"a": 1, "b": 0, "c": 5, "d": 2}, [2, 2, 0, 1], (0, 0, 0, 0)):
        np.testing.assert_array_equal(tt.resolve_budgets(9, over),
                                      jt.resolve_budgets(9, over))
    own = dict(spec, budgets=(4, 3, 2, 1))
    np.testing.assert_array_equal(_tree(ttopo, **own).resolve_budgets(5),
                                  _tree(jtopo, **own).resolve_budgets(5))
    for over in ({"a": 1}, [1, 2], [1, -1, 0, 0]):
        _raises_alike(lambda: jt.resolve_budgets(5, over),
                      lambda: tt.resolve_budgets(5, over))
    assert ttopo.flat_topology("x") == ttopo.AggregationTopology(leaves=("x",))
    assert ttopo.regions_topology(["p", "q"]).leaves == ("p", "q")


def test_registry_and_resolution_equal():
    assert ttopo.available_topologies() == jtopo.available_topologies()
    with pytest.raises(ValueError, match="already registered"):
        ttopo.register_topology("flat", ttopo._flat_factory)
    _raises_alike(lambda: jtopo.get_topology("star", None),
                  lambda: ttopo.get_topology("star", None))
    pools = {name: (jscen.build_scenario(name, N, seed=1),
                    tscen.build_scenario(name, N, seed=1, device="cpu"))
             for name in ("uniform", "hierarchical", "regional-outage")}
    for name, (jp, tp) in pools.items():
        for topo in ttopo.available_topologies():
            try:
                want = jtopo.get_topology(topo, jp)
            except ValueError as e:
                with pytest.raises(ValueError) as te:
                    ttopo.get_topology(topo, tp)
                assert str(te.value) == str(e)
                continue
            got = ttopo.get_topology(topo, tp)
            assert (got.leaves, got.root_children()) == (want.leaves, want.root_children())
            assert [dataclasses.astuple(t) for t in got.tiers] == \
                [dataclasses.astuple(t) for t in want.tiers]
        for topology in (None, "regions", "flat"):
            jc, tc = jfl.FLConfig(topology=topology), tfl.FLConfig(topology=topology)
            try:
                want = jtopo.resolve_topology(jc, jp)
            except ValueError as e:
                with pytest.raises(ValueError) as te:
                    ttopo.resolve_topology(tc, tp)
                assert str(te.value) == str(e)
                continue
            got = ttopo.resolve_topology(tc, tp)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.leaves == want.leaves
    with pytest.raises(TypeError, match="AggregationTopology"):
        ttopo.resolve_topology(tfl.FLConfig(topology=3), pools["uniform"][1])


def _custom_spec(mod):
    """Every regional override at once (tier mix, load, availability) over a
    custom tier table."""
    return mod.ScenarioSpec(
        name="custom-regions",
        tiers=((1e9, 5e6, 4e-9, 1e-7), (3e8, 2e6, 6e-9, 2e-7),
               (5e7, 5e5, 8e-9, 4e-7)),
        regions=(mod.RegionSpec("a", weight=2.0, tier_probs=(0.6, 0.3, 0.1),
                                load=mod.DiurnalLoad()),
                 mod.RegionSpec("b", weight=1.0,
                                availability=mod.ChurnAvailability(0.3, 0.3)),
                 mod.RegionSpec("c", weight=1.0, load=mod.FlashCrowdLoad(),
                                availability=mod.DiurnalAvailability(duty=0.3))),
        failures=mod.FailureModel(dropout=0.1))


@pytest.mark.parametrize("name", ["hierarchical", "regional-outage", "custom",
                                  "byzantine-scaled", "label-drift"])
def test_regioned_pools_equal(name):
    if name == "custom":
        jp = _custom_spec(jscen).build(N, seed=4)
        tp = _custom_spec(tscen).build(N, seed=4, device="cpu")
    else:
        jp = jscen.build_scenario(name, N, seed=4)
        tp = tscen.build_scenario(name, N, seed=4, device="cpu")
    np.testing.assert_array_equal(tp.region, jp.region)
    assert tp.region_names == jp.region_names and tp.n_regions == jp.n_regions
    np.testing.assert_array_equal(tp.tier, jp.tier)
    np.testing.assert_array_equal(tp.speed, jp.speed)
    for r in range(tp.n_regions):
        np.testing.assert_array_equal(tp.region_ids(r), jp.region_ids(r))
    assert type(tp.attack).__name__ == type(jp.attack).__name__
    flops = np.full(N, 1e8)
    for _ in range(20):
        jp.advance_round()
        tp.advance_round()
        np.testing.assert_array_equal(tp.available(), jp.available())
        np.testing.assert_array_equal(tp.system_state(flops, 1e5).t_comp,
                                      jp.system_state(flops, 1e5).t_comp)
        assert tp.next_transition() == jp.next_transition()


def test_fold_topology_equal():
    spec = dict(leaves=("metro", "suburban", "rural"),
                tiers=(("edge", ("metro", "suburban")),))
    jt, tt = _tree(jtopo, **spec), _tree(ttopo, **spec)
    rng = np.random.default_rng(0)

    def params():
        return {"w": rng.standard_normal((6, 4)).astype(np.float32),
                "b": rng.standard_normal(4).astype(np.float32)}

    g = params()
    deltas = {leaf: (params(), float(w)) for leaf, w in zip(spec["leaves"], (30, 50, 20))}
    cases = [
        (deltas, None, {}),
        (deltas, {"metro": 2, "suburban": 0, "rural": 5, "edge": 1},
         dict(kind="polynomial")),
        (deltas, {"rural": 3}, dict(kind="hinge", b=1)),
        ({k: deltas[k] for k in ("suburban", "rural")}, None, {}),   # a dark leaf
        (deltas, {"edge": 2}, dict(kind="polynomial", robust="coordinate_median")),
        ({}, None, {}),
    ]
    for ds, lags, kw in cases:
        want = jtopo.fold_topology(jt, g, ds, lags, **kw)
        got = ttopo.fold_topology(tt, _cpu(g), {k: (_cpu(p), w) for k, (p, w) in ds.items()},
                                  lags, **kw)
        _assert_close(want, got, 1e-6)


# ---------------------------------------------------------------------------
# synchronous hierarchical rounds
# ---------------------------------------------------------------------------


def _servers(d, **kw):
    cfg = dict(n_devices=N, k_select=6, rounds=3, l_ep=2, lr=0.1, seed=3,
               scenario="hierarchical")
    cfg.update(kw)
    jsrv = jfl.FLServer(jfl.FLConfig(**cfg), jfl.MLPTask(dim=32, hidden=32), d)
    tsrv = tfl.FLServer(tfl.FLConfig(**cfg), tfl.MLPTask(dim=32, hidden=32),
                        _tdata(d), device="cpu")
    return jsrv, tsrv


def _feed_server(jsrv, tsrv):
    tsrv.global_params = _cpu(jsrv.global_params)
    tsrv.last_loss = jsrv.last_loss.copy()
    tsrv.loss_age = jsrv.loss_age.copy()
    tsrv._last_acc = jsrv._last_acc


def _feed_fedrank(jpol, tpol):
    tpol.q, tpol.q_target = _cpu(jpol.q), _cpu(jpol.q_target)
    tpol._opt_m, tpol._opt_v = _cpu(jpol._opt_m), _cpu(jpol._opt_v)
    tpol._opt_t = int(jpol._opt_t)
    tpol.replay.items = list(jpol.replay.items)
    tpol._pending = jpol._pending


def _log_probes(policy):
    """Record (region, probe ids) of every probe_set call."""
    log = []
    probe_set = policy.probe_set

    def logged(ctx):
        ids = probe_set(ctx)
        log.append((ctx.region_name, [int(i) for i in ids]))
        return ids

    policy.probe_set = logged
    return log


def _assert_round_equal(jr, tr):
    for field in ("probe_set", "selected", "failed", "stragglers", "adversaries"):
        np.testing.assert_array_equal(getattr(tr, field), getattr(jr, field), field)
    assert (tr.round, tr.n_available) == (jr.round, jr.n_available)
    assert (tr.r_t, tr.r_e, tr.cum_time, tr.cum_energy) == (
        jr.r_t, jr.r_e, jr.cum_time, jr.cum_energy)
    assert tr.tier_staleness == jr.tier_staleness
    assert abs(tr.acc - jr.acc) <= 1e-5 and abs(tr.test_loss - jr.test_loss) <= 1e-5


@pytest.mark.parametrize("policy_name", ["fedavg", "fedrank"])
def test_hierarchical_sync_rounds_stage_by_stage(data30, policy_name):
    jsrv, tsrv = _servers(data30, topology="edge-hier")
    assert tsrv.topology.tier_path("metro") == ("edge", "root")
    if policy_name == "fedrank":
        jpol = jcore.FedRankPolicy(None, k=6, seed=0, train_batch=4,
                                   train_steps_per_round=1)
        tpol = tfl.build_policy("fedrank", qnet=_cpu(jpol.q), k=6, seed=0,
                                train_batch=4, train_steps_per_round=1)
    else:
        jpol, tpol = jfl.build_policy("fedavg"), tfl.build_policy("fedavg")
    jlog, tlog = _log_probes(jpol), _log_probes(tpol)
    for _ in range(3):
        _feed_server(jsrv, tsrv)
        if policy_name == "fedrank":
            _feed_fedrank(jpol, tpol)
        jr, tr = jsrv.run_round(jpol), tsrv.run_round(tpol)
        _assert_round_equal(jr, tr)
        budgets = tsrv.topology.resolve_budgets(6)
        for r in range(3):
            assert (tsrv.pool.region[tr.selected] == r).sum() <= budgets[r]
        _assert_close(jsrv.global_params, tsrv.global_params, 1e-5)
        if policy_name == "fedrank":
            _assert_close(jpol.q, tpol.q, 1e-4)
    assert tlog == jlog
    if policy_name == "fedrank":
        assert {name for name, _ in tlog} == {"metro", "suburban", "rural"}
    np.testing.assert_array_equal(tsrv.selection_count, jsrv.selection_count)
    assert tsrv.telemetry.region_mean(tsrv.telemetry.online_frac) == \
        jsrv.telemetry.region_mean(jsrv.telemetry.online_frac)


def _digest(srv):
    return [(r.round, r.selected.tolist(), r.probe_set.tolist(), r.failed.tolist(),
             r.stragglers.tolist(), r.adversaries.tolist(), r.acc, r.test_loss,
             r.r_t, r.r_e, r.cum_time, r.cum_energy, r.n_available,
             r.mean_staleness, r.max_staleness, r.n_pending,
             sorted(r.tier_staleness.items())) for r in srv.history]


def _same_params(a, b):
    return all(torch.equal(a.global_params[k], b.global_params[k])
               for k in a.global_params)


@pytest.mark.parametrize("policy_name,executor", [("fedrank", "sequential"),
                                                  ("fedavg", "vmapped")])
def test_region_exec_stacked_equals_sequential(data30, policy_name, executor):
    runs = []
    for mode in ("stacked", "sequential"):
        _, tsrv = _servers(data30, region_exec=mode, executor=executor,
                           scenario="byzantine-signflip", regions=3,
                           aggregator="trimmed_mean")
        kw = dict(k=6, seed=0, device="cpu") if policy_name == "fedrank" else {}
        tsrv.run(tfl.build_policy(policy_name, **kw))
        runs.append(tsrv)
    assert runs[0].pool.region_names == ["region0", "region1", "region2"]
    assert _digest(runs[0]) == _digest(runs[1])
    assert _same_params(runs[0], runs[1])
    with pytest.raises(ValueError, match="region_exec"):
        _servers(data30, region_exec="parallel")[1].run_round(tfl.build_policy("fedavg"))


def test_regional_outage_skips_dark_regions(data30):
    jsrv, tsrv = _servers(data30, scenario="regional-outage", rounds=12, seed=5)
    _feed_server(jsrv, tsrv)
    jh = jsrv.run(jfl.build_policy("fedavg"))
    th = tsrv.run(tfl.build_policy("fedavg"))
    dark_seen = 0
    for jr, tr in zip(jh, th):
        _assert_round_equal(jr, tr)
        present = {k.split(":", 1)[1] for k in tr.tier_staleness if k.startswith("region:")}
        sel_regions = {tsrv.pool.region_names[r] for r in tsrv.pool.region[tr.selected]}
        assert sel_regions <= present
        dark_seen += len(present) < 3
    assert dark_seen > 0, "no region went dark in 12 rounds"
    _assert_close(jsrv.global_params, tsrv.global_params, 1e-5)


def test_budget_overshoot_and_overrides(data30):
    _, tsrv = _servers(data30, region_budgets={"metro": 3, "suburban": 0, "rural": 1})
    res = tsrv.run_round(tfl.build_policy("fedavg"))
    assert not (tsrv.pool.region[res.selected] == 1).any()
    assert (tsrv.pool.region[res.selected] == 0).sum() <= 3

    class Greedy:
        name, needs_probing = "greedy", False

        def select(self, ctx, probe_ids, states):
            return ctx.available_ids()

        def observe(self, *a):
            pass

    _, tsrv = _servers(data30)
    with pytest.raises(ValueError, match="budget"):
        tsrv.run_round(Greedy())
    with pytest.raises(ValueError, match="conflicts"):
        _servers(data30, regions=2)


# ---------------------------------------------------------------------------
# asynchronous hierarchical engine, and the flat anchor
# ---------------------------------------------------------------------------


def _record_jobs(engine):
    log = []
    add = engine._add_job

    def recording_add(cid, **kw):
        log.append((int(cid), engine.version, engine._seq, engine.cycle,
                    kw["duration"], kw["energy"], kw["fail_at"],
                    kw["params"] is None))
        add(cid, **kw)

    engine._add_job = recording_add
    return log


def test_hierarchical_async_equals_reference(data30):
    jsrv, tsrv = _servers(data30, mode="async", async_concurrency=12,
                          staleness="polynomial", buffer_size=6)
    tsrv.global_params = _cpu(jsrv.global_params)
    tsrv._last_acc = jsrv._last_acc
    jeng = jtopo.HierarchicalAsyncEngine(jsrv, jfl.build_policy("fedavg"))
    teng = ttopo.HierarchicalAsyncEngine(tsrv, tfl.build_policy("fedavg"))
    assert (teng.region_buffer_size, teng.fanin) == (jeng.region_buffer_size, jeng.fanin)
    jlog, tlog = _record_jobs(jeng), _record_jobs(teng)
    jh, th = jeng.run(4), teng.run(4)
    assert tlog == jlog
    assert len(th) == 4
    lags_seen = False
    for jr, tr in zip(jh, th):
        _assert_round_equal(jr, tr)
        assert (tr.mean_staleness, tr.max_staleness, tr.n_pending) == (
            jr.mean_staleness, jr.max_staleness, jr.n_pending)
        lags_seen |= any(v > 0 for v in tr.tier_staleness.values())
    assert lags_seen, "no tier lag in 4 root merges"
    assert teng.version == jeng.version and teng.now == jeng.now
    _assert_close(jsrv.global_params, tsrv.global_params, 1e-5)


@pytest.mark.parametrize("mode,policy_name", [("sync", "fedrank"), ("async", "fedavg")])
def test_flat_topology_is_the_flat_run(data30, mode, policy_name):
    runs = []
    for topology in (None, "flat"):
        _, tsrv = _servers(data30, scenario="high-churn", mode=mode,
                           topology=topology, async_concurrency=12)
        assert (tsrv.topology is None) == (topology is None)
        kw = dict(k=6, seed=0, device="cpu") if policy_name == "fedrank" else {}
        tsrv.run(tfl.build_policy(policy_name, **kw))
        runs.append(tsrv)
    flat, hier = runs
    strip = lambda d: [row[:-1] for row in d]        # tier_staleness: flat runs have none
    assert strip(_digest(flat)) == strip(_digest(hier))
    assert _same_params(flat, hier)
    assert all(r.tier_staleness for r in hier.history)
