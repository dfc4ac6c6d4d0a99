"""The port's synchronous FedRank/FedAvg rounds against the JAX reference.

Stage by stage: before each round the reference's global params, Q-nets (with
their Adam state) and loss bookkeeping are copied into the port, then both run
the round.  Probe set, cohort, failures, stragglers, round latency/energy and
the cumulative virtual clock must be exactly equal; accuracy and test loss
agree within 1e-5; the Q-net after ``observe`` within 1e-4.

The policies take one train step per round here.  Gradients agree to ~1e-7
(fp32 sums in another order), but Adam divides each step by the root of the
second moment: over several steps an entry whose gradients change sign has a
near-cancelling mean, and the ratio turns 1e-7 of noise into ~1e-4 of
parameter drift.  One step from given moments keeps the comparison about the
port, not about that amplification; ``test_torch_core`` holds a single step to
1e-5.
"""
import numpy as np
import pytest

import repro.core as jcore
import repro.fl as jfl
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.fl as tfl
from repro_torch.convert import params_from_numpy, params_to_numpy

ROUNDS = 3


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _cpu(tree):
    return params_from_numpy(_np(tree), "cpu")


def _assert_close(ref, got, tol):
    ref, got = _np(ref), params_to_numpy(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol, err_msg=k)


def _servers(fl_data, seed):
    kw = dict(n_devices=20, k_select=3, rounds=ROUNDS, l_ep=2,
              scenario="high-churn", seed=seed)
    jsrv = jfl.FLServer(jfl.FLConfig(**kw), jfl.MLPTask(dim=32, hidden=32), fl_data)
    data = tdata.FederatedData(fl_data.train, fl_data.test, fl_data.client_indices)
    tsrv = tfl.FLServer(tfl.FLConfig(**kw), tfl.MLPTask(dim=32, hidden=32), data,
                        device="cpu")
    return jsrv, tsrv


def _feed_server(jsrv, tsrv):
    tsrv.global_params = _cpu(jsrv.global_params)
    tsrv.last_loss = jsrv.last_loss.copy()
    tsrv.loss_age = jsrv.loss_age.copy()
    tsrv._last_acc = jsrv._last_acc


def _feed_fedrank(jpol, tpol):
    tpol.q = _cpu(jpol.q)
    tpol.q_target = _cpu(jpol.q_target)
    tpol._opt_m = _cpu(jpol._opt_m)
    tpol._opt_v = _cpu(jpol._opt_v)
    tpol._opt_t = int(jpol._opt_t)
    # the Profiler Cache holds numpy transitions: share the reference's
    tpol.replay.items = list(jpol.replay.items)
    tpol._pending = jpol._pending


def _assert_round_matches(jr, tr):
    np.testing.assert_array_equal(tr.probe_set, jr.probe_set)
    np.testing.assert_array_equal(tr.selected, jr.selected)
    np.testing.assert_array_equal(tr.failed, jr.failed)
    np.testing.assert_array_equal(tr.stragglers, jr.stragglers)
    assert tr.round == jr.round
    assert tr.n_available == jr.n_available
    assert (tr.r_t, tr.r_e) == (jr.r_t, jr.r_e)
    assert (tr.cum_time, tr.cum_energy) == (jr.cum_time, jr.cum_energy)
    np.testing.assert_allclose(tr.acc, jr.acc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tr.test_loss, jr.test_loss, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_fedavg_rounds_stage_by_stage(fl_data, seed):
    jsrv, tsrv = _servers(fl_data, seed)
    np.testing.assert_allclose(tsrv.t_budget, jsrv.t_budget, rtol=0)
    np.testing.assert_allclose(tsrv.e_budget, jsrv.e_budget, rtol=0)
    jpol, tpol = jcore.RandomPolicy("fedavg"), tfl.build_policy("fedavg")
    for _ in range(ROUNDS):
        _feed_server(jsrv, tsrv)
        jr, tr = jsrv.run_round(jpol), tsrv.run_round(tpol)
        _assert_round_matches(jr, tr)
        _assert_close(jsrv.global_params, tsrv.global_params, 1e-5)
        np.testing.assert_array_equal(tsrv.selection_count, jsrv.selection_count)


@pytest.mark.parametrize("seed", [0, 5])
def test_fedrank_rounds_stage_by_stage(fl_data, seed):
    jsrv, tsrv = _servers(fl_data, seed)
    jpol = jcore.FedRankPolicy(None, k=3, seed=0, train_batch=4,
                               train_steps_per_round=1)
    tpol = tfl.build_policy("fedrank", qnet=_cpu(jpol.q), k=3, seed=0,
                            train_batch=4, train_steps_per_round=1)
    for _ in range(ROUNDS):
        _feed_server(jsrv, tsrv)
        _feed_fedrank(jpol, tpol)
        jr, tr = jsrv.run_round(jpol), tsrv.run_round(tpol)
        _assert_round_matches(jr, tr)
        _assert_close(jsrv.global_params, tsrv.global_params, 1e-5)
        _assert_close(jpol.q, tpol.q, 1e-4)
        _assert_close(jpol.q_target, tpol.q_target, 1e-4)
    # the third round's observe trained the Q-net (replay reached 2 items)
    assert len(jpol.metrics["loss"]) == len(tpol.metrics["loss"]) == 1
    np.testing.assert_allclose(tpol.metrics["loss"], jpol.metrics["loss"],
                               rtol=1e-4, atol=1e-4)


def test_fedrank_cold_start_on_cpu_runs(fl_data):
    """A fresh port Q-net (torch.Generator init) drives the same loop."""
    _, tsrv = _servers(fl_data, 0)
    pol = tfl.build_policy("fedrank-IP", k=3, seed=1, device="cpu")
    hist = tsrv.run(pol)
    assert len(hist) == ROUNDS
    for r in hist:
        assert len(set(r.selected.tolist())) == len(r.selected) <= 3
        assert set(r.selected.tolist()) <= set(r.probe_set.tolist())
        assert np.isfinite(r.acc)
    assert tcore.FedRankPolicy is type(pol)
