"""The port's FL substrate against the JAX reference, on the CPU.

Same numpy inputs through both packages in one process: data arrays and the
fleet simulator's streams (availability, failure draws, latency, energy) must
be exactly equal; MLPTask loss/accuracy agree within 1e-6, local training
within 1e-5 (fp32 sums in another order), fedavg within 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.fl.aggregation as jagg
import repro.fl.client as jclient
import repro.fl.scenarios as jscen
import repro.fl.simulation as jsim
import repro.fl.tasks as jtasks
import repro_torch.data as tdata
import repro_torch.fl.aggregation as tagg
import repro_torch.fl.client as tclient
import repro_torch.fl.scenarios as tscen
import repro_torch.fl.simulation as tsim
import repro_torch.fl.tasks as ttasks
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl.engine import available_executors, make_executor


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _assert_params_close(ref, got, tol):
    ref, got = _np(ref), params_to_numpy(got)
    assert ref.keys() == got.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(500, 0), (3000, 7)])
def test_classification_data_equal(n, seed):
    jtr, jte = jdata.make_classification_data(n_samples=n, seed=seed)
    ttr, tte = tdata.make_classification_data(n_samples=n, seed=seed)
    for a, b in ((jtr, ttr), (jte, tte)):
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
        assert a.n_classes == b.n_classes


@pytest.mark.parametrize("n_clients,sigma", [(20, 0.1), (50, 0.01)])
def test_dirichlet_partition_equal(n_clients, sigma):
    y = np.random.default_rng(3).integers(0, 10, size=2000)
    ref = jdata.dirichlet_partition(y, n_clients, sigma=sigma, seed=1)
    got = tdata.dirichlet_partition(y, n_clients, sigma=sigma, seed=1)
    assert len(ref) == len(got)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("skew", [0.0, 0.8])
def test_iid_partition_equal(skew):
    ref = jdata.iid_partition(1000, 13, seed=2, size_skew=skew)
    got = tdata.iid_partition(1000, 13, seed=2, size_skew=skew)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# MLPTask + local training
# ---------------------------------------------------------------------------


def _tasks(hidden=32):
    return jtasks.MLPTask(hidden=hidden), ttasks.MLPTask(hidden=hidden)


def _batch(n, seed, masked=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 32)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    mask = (rng.random(n) > 0.25).astype(np.float32) if masked else None
    return x, y, mask


@pytest.mark.parametrize("masked", [False, True])
def test_mlp_task_loss_and_accuracy(masked):
    jt, tt = _tasks()
    jp = jt.init(jax.random.PRNGKey(4))
    tp = params_from_numpy(_np(jp), "cpu")
    x, y, mask = _batch(96, 4, masked)
    jb = {"x": x, "y": y} if mask is None else {"x": x, "y": y, "mask": mask}
    tb = {k: torch.as_tensor(v) for k, v in jb.items()}
    np.testing.assert_allclose(float(tt.loss(tp, tb)), float(jt.loss(jp, jb)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(float(tt.accuracy(tp, tb)),
                               float(jt.accuracy(jp, jb)), rtol=1e-6, atol=1e-6)


def test_mlp_task_init_shapes_and_costs():
    jt, tt = jtasks.MLPTask(), ttasks.MLPTask()
    jp = _np(jt.init(jax.random.PRNGKey(0)))
    tp = params_to_numpy(tt.init(0, device="cpu"))
    assert {k: v.shape for k, v in jp.items()} == {k: v.shape for k, v in tp.items()}
    assert all(v.dtype == np.float32 for v in tp.values())
    # truncated-normal fan-in: |w| <= 2 / sqrt(fan_in)
    assert np.abs(tp["w1"]).max() <= 2.0 / np.sqrt(32) + 1e-7
    assert tt.flops_per_sample() == jt.flops_per_sample()
    assert tt.param_bytes() == jt.param_bytes()


@pytest.mark.parametrize("n,prox_mu", [(45, 0.0), (5, 0.0), (70, 0.1)])
def test_local_train_two_epochs(n, prox_mu):
    jt, tt = _tasks()
    jp = jt.init(jax.random.PRNGKey(n))
    tp = params_from_numpy(_np(jp), "cpu")
    x, y, _ = _batch(n, n + 1)
    jp2, jl = jclient.local_train(jt, jp, x, y, epochs=2, lr=0.05,
                                  batch_size=32, prox_mu=prox_mu, seed=11)
    tp2, tl = tclient.local_train(tt, tp, x, y, epochs=2, lr=0.05,
                                  batch_size=32, prox_mu=prox_mu, seed=11)
    _assert_params_close(jp2, tp2, 1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)


def test_bucket_geometry_equal():
    for n in (1, 7, 8, 9, 33, 100, 1000):
        assert tclient._bucket_geometry(n, 32) == jclient._bucket_geometry(n, 32)


# ---------------------------------------------------------------------------
# fleet simulator + scenarios: exact streams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scenario", ["uniform", "high-churn", "nightly-chargers",
                                      "cellular-tail", "flash-crowd",
                                      "stragglers"])
def test_scenario_streams_exactly_equal(scenario):
    n = 200
    jpool = jscen.build_scenario(scenario, n, seed=3)
    tpool = tscen.build_scenario(scenario, n, seed=3)
    flops = np.random.default_rng(0).integers(8, 400, size=n) * 1e5
    jrng, trng = np.random.default_rng(9), np.random.default_rng(9)
    for attr in ("tier", "speed", "bandwidth", "j_per_flop", "j_per_byte"):
        np.testing.assert_array_equal(getattr(jpool, attr), getattr(tpool, attr))
    for _ in range(5):
        jpool.advance_round()
        tpool.advance_round()
        avail = jpool.available()
        np.testing.assert_array_equal(avail, tpool.available())
        js = jpool.system_state(flops, 1e5)
        ts = tpool.system_state(flops, 1e5)
        for f in ("t_comp", "t_comm", "e_comp", "e_comm", "load"):
            np.testing.assert_array_equal(getattr(js, f), getattr(ts, f))
        sel = np.flatnonzero(avail)[:12]
        probe = np.flatnonzero(avail)[:30]
        comp = js.t_comm[sel] + js.t_comp[sel] * 4
        jo = jpool.draw_failures(jrng, sel, comp)
        to = tpool.draw_failures(trng, sel, comp)
        np.testing.assert_array_equal(jo.failed, to.failed)
        np.testing.assert_array_equal(jo.stragglers, to.stragglers)
        assert jo.deadline_s == to.deadline_s
        for pe, ce in ((1, 4), (0, 5)):
            pids = probe if pe else np.empty(0, np.int64)
            assert (jsim.plan_round_latency(js, pids, sel, pe, ce, jo.deadline_s)
                    == tsim.plan_round_latency(ts, pids, sel, pe, ce, to.deadline_s))
            assert (jsim.plan_round_energy(js, pids, sel, pe, ce, jo.deadline_s)
                    == tsim.plan_round_energy(ts, pids, sel, pe, ce, to.deadline_s))
    jt, je = jsim.static_estimates(jpool, flops, 1e5, 5)
    tt, te = tsim.static_estimates(tpool, flops, 1e5, 5)
    np.testing.assert_array_equal(jt, tt)
    np.testing.assert_array_equal(je, te)


def test_unported_scenarios_and_executors_raise():
    """Every scenario and executor of the reference is registered; unknown
    names raise, listing the registered ones.  Scenarios that other test
    files register in the reference's registry (``test-*``, e.g.
    ``tests/test_traces.py``'s) are not the reference's own: whether one of
    them is there depends on which files ran before in this process."""
    ref_own = [n for n in jscen.available_scenarios() if not n.startswith("test-")]
    assert tscen.available_scenarios() == ref_own
    for name in ("hierarchical", "regional-outage", "byzantine-signflip"):
        assert tscen.build_scenario(name, 10, device="cpu").n == 10
    with pytest.raises(KeyError, match="registered"):
        tscen.build_scenario("no-such-scenario", 10)
    assert available_executors() == ["async", "sequential", "vmapped"]
    with pytest.raises(KeyError, match="sequential"):
        make_executor("remote")


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def test_fedavg_matches_reference():
    rng = np.random.default_rng(12)
    clients = [{"w": rng.normal(size=(6, 5)).astype(np.float32),
                "b": rng.normal(size=(5,)).astype(np.float32)} for _ in range(7)]
    weights = rng.integers(8, 300, size=7)
    ref = jagg.fedavg([{k: jax.numpy.asarray(v) for k, v in c.items()}
                       for c in clients], weights)
    got = tagg.fedavg([params_from_numpy(c, "cpu") for c in clients], weights)
    _assert_params_close(ref, got, 1e-6)
    got_mean = tagg.robust_aggregate([params_from_numpy(c, "cpu")
                                      for c in clients], weights, kind="mean")
    _assert_params_close(ref, got_mean, 1e-6)
    got_krum = tagg.robust_aggregate([params_from_numpy(c, "cpu")
                                      for c in clients], weights, kind="krum")
    _assert_params_close(jagg.robust_aggregate(clients, weights, kind="krum"),
                         got_krum, 1e-6)
