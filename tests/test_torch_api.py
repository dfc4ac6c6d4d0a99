"""Public names of ported modules against the JAX reference, on the CPU.

Registries, the target-network update, the FedOpt server step, the client
task protocol, the data loader's iterators, the fleet's device profiles and
round cost helpers, and the ``FLConfig`` field ``failure_rate``: the same
numpy inputs through both packages.  numpy
streams (batches, histograms, profiles, latency, energy, failure draws) must
be exactly equal; fp32 arithmetic agrees to fp32 rounding.
"""
import dataclasses
import inspect

import numpy as np
import pytest

import repro.core.qnet as jqnet
import repro.data as jdata
import repro.fl as jfl
import repro.fl.aggregation as jagg
import repro.fl.engine as jengine
import repro.fl.registry as jreg
import repro.fl.simulation as jsim
import repro.fl.tasks as jtasks
import repro_torch.core.qnet as tqnet
import repro_torch.data as tdata
import repro_torch.fl as tfl
import repro_torch.fl.aggregation as tagg
import repro_torch.fl.engine as tengine
import repro_torch.fl.registry as treg
import repro_torch.fl.simulation as tsim
import repro_torch.fl.tasks as ttasks
from repro_torch.convert import params_from_numpy, params_to_numpy

FP32_RTOL = 2.0 ** -22       # two fp32 roundings of the result


def _params(rng, scale=1.0):
    return {"w": (scale * rng.normal(size=(6, 5))).astype(np.float32),
            "b": (scale * rng.normal(size=(5,))).astype(np.float32)}


def _assert_tree_close(ref, got):
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = params_to_numpy(got)
    assert ref.keys() == got.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_allclose(got[k], ref[k], rtol=FP32_RTOL, atol=1e-7, err_msg=k)


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_register_policy_builds_and_refuses_duplicates(pkg):
    reg = jreg if pkg == "reference" else treg
    base = jfl.build_policy("fedavg") if pkg == "reference" else tfl.build_policy("fedavg")
    name = f"test-registered-{pkg}"
    try:
        reg.register_policy(name, lambda **kw: ("built", kw))
        assert reg.build_policy(name, k=3) == ("built", {"k": 3})
        assert name in reg.available_policies()
        with pytest.raises(ValueError, match="already registered"):
            reg.register_policy(name, lambda **kw: None)
        with pytest.raises(ValueError, match="already registered"):
            reg.register_policy("fedavg", lambda **kw: None)
    finally:
        reg._POLICIES.pop(name, None)
    assert type(base).__name__ == "RandomPolicy"
    assert name not in reg.available_policies()


def test_policy_registries_hold_the_same_builtin_names():
    ported = set(treg.available_policies())
    assert ported <= set(jreg.available_policies())
    assert {"fedavg", "fedrank", "oort", "expert-oort"} <= ported


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_register_executor_builds_and_refuses_duplicates(pkg):
    eng = jengine if pkg == "reference" else tengine
    name = f"test-executor-{pkg}"
    try:
        eng.register_executor(name, lambda **kw: ("built", kw))
        assert eng.make_executor(name, x=1) == ("built", {"x": 1})
        assert name in eng.available_executors()
        for taken in (name, "sequential", "async"):
            with pytest.raises(ValueError, match="already registered"):
                eng.register_executor(taken, lambda **kw: None)
    finally:
        eng._EXECUTORS.pop(name, None)
    assert {"sequential", "async"} <= set(eng.available_executors())
    assert name not in eng.available_executors()
    assert type(eng.make_executor("sequential")).__name__ == "SequentialExecutor"


# ---------------------------------------------------------------------------
# Q-net target update, FedOpt server step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tau", [0.005, 0.5, 1.0])
def test_soft_update_matches_reference(tau):
    rng = np.random.default_rng(int(tau * 1000))
    target, online = _params(rng), _params(rng)
    want = jqnet.soft_update(target, online, tau=tau)
    got = tqnet.soft_update(params_from_numpy(target, "cpu"),
                            params_from_numpy(online, "cpu"), tau=tau)
    _assert_tree_close(want, got)


@pytest.mark.parametrize("server_lr", [0.5, 1.0, 1.7])
def test_weighted_delta_aggregate_matches_reference(server_lr):
    rng = np.random.default_rng(int(server_lr * 10))
    glob = _params(rng)
    clients = [_params(rng) for _ in range(5)]
    weights = rng.integers(10, 200, size=5).astype(np.float64)
    want = jagg.weighted_delta_aggregate(glob, clients, weights, server_lr=server_lr)
    got = tagg.weighted_delta_aggregate(
        params_from_numpy(glob, "cpu"), [params_from_numpy(c, "cpu") for c in clients],
        weights, server_lr=server_lr)
    _assert_tree_close(want, got)
    if server_lr == 1.0:
        avg = tagg.fedavg([params_from_numpy(c, "cpu") for c in clients], weights)
        _assert_tree_close(params_to_numpy(avg), got)


# ---------------------------------------------------------------------------
# the client task protocol
# ---------------------------------------------------------------------------


def _protocol_methods(proto):
    return {n for n, v in vars(proto).items()
            if inspect.isfunction(v) and not n.startswith("_")}


def test_mlp_task_satisfies_client_task():
    methods = _protocol_methods(ttasks.ClientTask)
    assert methods == _protocol_methods(jtasks.ClientTask)
    for name in methods:
        want = inspect.signature(getattr(ttasks.ClientTask, name)).parameters.values()
        have = inspect.signature(getattr(ttasks.MLPTask, name)).parameters.values()
        assert [(q.kind, q.default) for q in have] == \
            [(q.kind, q.default) for q in want], name
    task = ttasks.MLPTask(dim=8, hidden=16)
    p = task.init(3, device="cpu")
    assert task.param_bytes() == jtasks.MLPTask(dim=8, hidden=16).param_bytes()
    assert task.param_bytes() == 4.0 * sum(v.numel() for v in p.values())


# ---------------------------------------------------------------------------
# data loader
# ---------------------------------------------------------------------------


def _federated(n_clients=12, seed=4):
    jtr, jte = jdata.make_classification_data(n_samples=900, seed=seed)
    idx = jdata.dirichlet_partition(jtr.y, n_clients, sigma=0.3, seed=seed)
    ttr, tte = tdata.make_classification_data(n_samples=900, seed=seed)
    return jdata.FederatedData(jtr, jte, idx), tdata.FederatedData(ttr, tte, idx)


@pytest.mark.parametrize("batch_size", [8, 32, 1000])
def test_client_batches_and_histograms_equal(batch_size):
    jd, td = _federated()
    for k in range(jd.n_clients):
        np.testing.assert_array_equal(td.label_histogram(k), jd.label_histogram(k))
        ref = list(jd.client_batches(k, batch_size, epoch_seed=11 + k))
        got = list(td.client_batches(k, batch_size, epoch_seed=11 + k))
        assert len(got) == len(ref)
        for (jx, jy), (tx, ty) in zip(ref, got):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


@pytest.mark.parametrize("batch_size,seed", [(16, 0), (50, 3), (301, 1)])
def test_batch_iterator_equal(batch_size, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(300, 4)).astype(np.float32)
    y = rng.integers(0, 10, size=300)
    ref = list(jdata.batch_iterator(x, y, batch_size, seed=seed))
    got = list(tdata.batch_iterator(x, y, batch_size, seed=seed))
    assert len(got) == len(ref) == 300 // batch_size
    for (jx, jy), (tx, ty) in zip(ref, got):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)


# ---------------------------------------------------------------------------
# fleet simulator: device profiles, round cost helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(7, 0), (300, 9)])
def test_device_profiles_equal(n, seed):
    ref = jsim.DevicePool(n, seed=seed).devices
    got = tsim.DevicePool(n, seed=seed).devices
    assert [f.name for f in dataclasses.fields(tsim.DeviceProfile)] == \
        [f.name for f in dataclasses.fields(jsim.DeviceProfile)]
    assert [dataclasses.astuple(d) for d in got] == [dataclasses.astuple(d) for d in ref]


def _round_state(mod, rng, n=40):
    arrays = [rng.uniform(0.5, 30.0, n), rng.uniform(2.0, 9.0, n),
              rng.uniform(1.0, 50.0, n), rng.uniform(0.1, 5.0, n),
              rng.uniform(0.3, 1.0, n)]
    return mod.RoundSystemState(*arrays)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_round_cost_helpers_equal(seed):
    js = _round_state(jsim, np.random.default_rng(seed))
    ts = _round_state(tsim, np.random.default_rng(seed))
    rng = np.random.default_rng(100 + seed)
    probe = rng.choice(40, size=9, replace=False)
    selected = probe[:4]
    for l_ep in (1, 2, 5):
        for fn in ("round_latency", "round_energy"):
            got = getattr(tsim, fn)(ts, probe, selected, l_ep)
            assert isinstance(got, float)
            assert got == getattr(jsim, fn)(js, probe, selected, l_ep), fn
        for fn in ("vanilla_round_latency", "vanilla_round_energy"):
            got = getattr(tsim, fn)(ts, selected, l_ep)
            assert isinstance(got, float)
            assert got == getattr(jsim, fn)(js, selected, l_ep), fn
        for fn in ("client_job_latency", "client_job_energy"):
            for comm in (True, False):
                np.testing.assert_array_equal(
                    getattr(tsim, fn)(ts, probe, l_ep, include_comm=comm),
                    getattr(jsim, fn)(js, probe, l_ep, include_comm=comm))
    assert tsim.vanilla_round_latency(ts, np.empty(0, np.int64), 3) == 0.0


# ---------------------------------------------------------------------------
# FLConfig.failure_rate
# ---------------------------------------------------------------------------


def _servers(fl_data, **kw):
    kw = dict(n_devices=20, k_select=6, rounds=2, l_ep=2, seed=3, **kw)
    jsrv = jfl.FLServer(jfl.FLConfig(**kw), jfl.MLPTask(dim=32, hidden=32), fl_data)
    data = tdata.FederatedData(fl_data.train, fl_data.test, fl_data.client_indices)
    tsrv = tfl.FLServer(tfl.FLConfig(**kw), tfl.MLPTask(dim=32, hidden=32), data,
                        device="cpu")
    return jsrv, tsrv


@pytest.mark.parametrize("scenario", ["uniform", "stragglers"])
def test_failure_rate_fails_the_same_devices(fl_data, scenario):
    jsrv, tsrv = _servers(fl_data, scenario=scenario, failure_rate=0.3)
    assert dataclasses.astuple(tsrv.pool.failures) == dataclasses.astuple(jsrv.pool.failures)
    assert tsrv.pool.failures.dropout >= 0.3
    jpol, tpol = jfl.build_policy("fedavg"), tfl.build_policy("fedavg")
    n_failed = 0
    for _ in range(2):
        tsrv.global_params = params_from_numpy(
            {k: np.asarray(v) for k, v in jsrv.global_params.items()}, "cpu")
        jr, tr = jsrv.run_round(jpol), tsrv.run_round(tpol)
        np.testing.assert_array_equal(tr.selected, jr.selected)
        np.testing.assert_array_equal(tr.failed, jr.failed)
        np.testing.assert_array_equal(tr.stragglers, jr.stragglers)
        assert (tr.r_t, tr.r_e) == (jr.r_t, jr.r_e)
        n_failed += len(tr.failed)
    assert n_failed > 0


def test_failure_rate_zero_keeps_the_scenario_model(fl_data):
    jsrv, tsrv = _servers(fl_data, scenario="stragglers")
    assert dataclasses.astuple(tsrv.pool.failures) == dataclasses.astuple(jsrv.pool.failures)

