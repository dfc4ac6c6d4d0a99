"""Imitation-learning pretraining in the port against the JAX reference, on
the CPU.

Experts, synthetic states and augmented demonstrations are host numpy in
both packages and must be exactly equal.  Demonstration collection is held
stage by stage: the port's server starts from the reference's global params,
then one recorded round must probe the same devices with states within 1e-5
(the probe losses come out of fp32 local training).  ``pretrain_qnet`` starts
from the reference's Q-net on the same demonstrations: one step's loss and
params within 1e-5; several steps within 1e-4 (Adam amplifies fp32 noise on
entries with near-cancelling gradient means, see ``test_torch_slice``);
ranking accuracy and top-10 overlap within 1e-6.

One exception, by construction: under the pairwise objective the output bias
``b3`` shifts every score alike, so its gradient is exactly zero in exact
arithmetic and what fp32 leaves of it is rounding noise.  Adam's first step
normalises that noise into an update of up to ``lr``, with a sign set by the
noise.  Nothing else depends on ``b3`` there (it sits after the last layer),
so the pairwise cases hold ``b3`` only to within ``lr`` of its start on both
sides.
"""
import jax
import numpy as np
import pytest

import repro.core as jcore
import repro.core.experts as jexperts
import repro.core.features as jfeat
import repro.core.qnet as jqnet
import repro.fl as jfl
import repro_torch.core as tcore
import repro_torch.core.experts as texperts
import repro_torch.core.features as tfeat
import repro_torch.data as tdata
import repro_torch.fl as tfl
from repro_torch.convert import params_from_numpy, params_to_numpy


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _cpu(tree):
    return params_from_numpy(_np(tree), "cpu")


def _assert_close(ref, got, tol, skip=()):
    ref, got = _np(ref), params_to_numpy(got)
    for k in ref:
        if k not in skip:
            np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol,
                                       err_msg=k)


@pytest.mark.parametrize("feature_set", ["paper6", "telemetry"])
def test_synthetic_states_exactly_equal(feature_set):
    jfs, tfs = jfeat.get_feature_set(feature_set), tfeat.get_feature_set(feature_set)
    a = jfs.synthetic_states(np.random.default_rng(3), 30)
    b = tfs.synthetic_states(np.random.default_rng(3), 30)
    assert b.shape == (30, tfs.state_dim)
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("name", ["oort", "harmony", "fedmarl"])
@pytest.mark.parametrize("feature_set", ["paper6", "telemetry"])
def test_experts_exactly_equal(name, feature_set):
    states = jfeat.get_feature_set(feature_set).synthetic_states(
        np.random.default_rng(7), 25)
    assert sorted(texperts.EXPERTS) == sorted(jexperts.EXPERTS)
    for l_ep in (1, 5):
        np.testing.assert_array_equal(
            texperts.expert_scores(name, states, l_ep=l_ep),
            jexperts.expert_scores(name, states, l_ep=l_ep))
    np.testing.assert_array_equal(
        texperts.oort_utility(states, t_budget=30.0, alpha=1.5),
        jexperts.oort_utility(states, t_budget=30.0, alpha=1.5))


@pytest.mark.parametrize("feature_set", ["paper6", "telemetry"])
def test_augment_demonstrations_exactly_equal(feature_set):
    a = jcore.augment_demonstrations([], n_synthetic=12, seed=5,
                                     feature_set=feature_set)
    b = tcore.augment_demonstrations([], n_synthetic=12, seed=5,
                                     feature_set=feature_set)
    assert [d.expert for d in b] == [d.expert for d in a]
    for da, db in zip(a, b):
        np.testing.assert_array_equal(db.states, da.states)
        np.testing.assert_array_equal(db.scores, da.scores)


CFG = dict(n_devices=20, k_select=3, rounds=1, l_ep=2, scenario="high-churn",
           seed=2)


def _port_server(fl_data):
    data = tdata.FederatedData(fl_data.train, fl_data.test, fl_data.client_indices)
    return tfl.FLServer(tfl.FLConfig(**CFG), tfl.MLPTask(dim=32, hidden=32), data,
                        device="cpu")


def _servers(fl_data):
    jsrv = jfl.FLServer(jfl.FLConfig(**CFG), jfl.MLPTask(dim=32, hidden=32),
                        fl_data)
    tsrv = _port_server(fl_data)
    tsrv.global_params = _cpu(jsrv.global_params)
    return jsrv, tsrv


@pytest.mark.parametrize("expert", ["oort", "fedmarl"])
def test_collect_demonstrations_first_round(fl_data, expert):
    made = {"j": [], "t": []}

    def make(side):
        def factory():
            jsrv, tsrv = _servers(fl_data)
            srv = jsrv if side == "j" else tsrv
            made[side].append(srv)
            return srv
        return factory

    ja = jcore.collect_demonstrations(make("j"), (expert,), rounds_per_expert=1)
    ta = tcore.collect_demonstrations(make("t"), (expert,), rounds_per_expert=1)
    assert len(ja) == len(ta) == 1 and ta[0].expert == expert
    np.testing.assert_array_equal(made["t"][0].history[0].probe_set,
                                  made["j"][0].history[0].probe_set)
    assert ta[0].states.shape == ja[0].states.shape
    np.testing.assert_allclose(ta[0].states, ja[0].states, rtol=1e-5, atol=1e-5)
    # the non-loss columns are the simulator's, exactly
    np.testing.assert_array_equal(ta[0].states[:, [0, 1, 2, 3, 5]],
                                  ja[0].states[:, [0, 1, 2, 3, 5]])


def _demos(n=10):
    """Synthetic cohorts of two sizes, so pretraining pads to max_m."""
    demos = jcore.augment_demonstrations([], n_synthetic=n, seed=1)
    fs = jfeat.get_feature_set("paper6")
    rng = np.random.default_rng(4)
    for name in ("oort", "harmony"):
        states = fs.synthetic_states(rng, 17)
        demos.append(jcore.imitation.Demonstration(
            states, jexperts.expert_scores(name, states, l_ep=5), name))
    return demos


def _as_port(demos):
    return [tcore.Demonstration(d.states, d.scores, d.expert) for d in demos]


LR = 1e-3


def _pretrain_both(steps, batch, objective="pairwise", rank_impl="auto"):
    """Both packages from the reference's Q-net; returns (jq, jhist, tq,
    thist, params the comparison skips)."""
    demos = _demos()
    q0 = jqnet.init_qnet(jax.random.PRNGKey(9))
    jq, jhist = jcore.pretrain_qnet(demos, seed=3, steps=steps, batch=batch,
                                    lr=LR, qnet_params=q0, objective=objective,
                                    rank_impl=rank_impl)
    tq, thist = tcore.pretrain_qnet(_as_port(demos), seed=3, steps=steps,
                                    batch=batch, lr=LR, qnet_params=_cpu(q0),
                                    objective=objective)
    if objective != "pairwise":
        return jq, jhist, tq, thist, ()
    b3 = float(np.asarray(q0["b3"])[0])
    for q in (_np(jq), params_to_numpy(tq)):
        assert abs(float(q["b3"][0]) - b3) <= steps * LR * (1 + 1e-6)
    return jq, jhist, tq, thist, ("b3",)


def _assert_hist(jhist, thist, loss_tol):
    assert len(thist["loss"]) == len(jhist["loss"])
    np.testing.assert_allclose(thist["loss"], jhist["loss"], rtol=loss_tol,
                               atol=loss_tol)
    for key in ("rank_acc", "top10_overlap"):
        np.testing.assert_allclose(thist[key], jhist[key], rtol=0, atol=1e-6)


@pytest.mark.parametrize("objective", ["pairwise", "pointwise", "pointwise_raw"])
def test_pretrain_one_step_matches(objective):
    jq, jhist, tq, thist, skip = _pretrain_both(1, 4, objective)
    assert all(t.device.type == "cpu" for t in tq.values())
    _assert_close(jq, tq, 1e-5, skip)
    _assert_hist(jhist, thist, 1e-5)


def test_pretrain_six_steps_at_batch_two():
    jq, jhist, tq, thist, skip = _pretrain_both(6, 2)
    _assert_close(jq, tq, 1e-4, skip)
    _assert_hist(jhist, thist, 1e-4)


def test_pretrain_against_the_pallas_kernel():
    jq, jhist, tq, thist, skip = _pretrain_both(1, 4, rank_impl="pallas")
    _assert_close(jq, tq, 1e-5, skip)
    _assert_hist(jhist, thist, 1e-5)


def test_pretrain_refuses_mismatched_width_and_objective():
    demos = _as_port(_demos(2))
    with pytest.raises(ValueError, match="feature set 'telemetry'"):
        tcore.pretrain_qnet(demos, steps=1, feature_set="telemetry", device="cpu")
    with pytest.raises(ValueError, match="objective"):
        tcore.pretrain_qnet(demos, steps=1, objective="listwise", device="cpu")


def test_il_then_fedrank_rounds_on_cpu(fl_data):
    """The slice end to end on the port: collect, augment, pretrain, then
    FedRank rounds from the pretrained Q-net."""
    def make():
        return _port_server(fl_data)

    demos = tcore.collect_demonstrations(make, ("oort", "harmony"),
                                         rounds_per_expert=1)
    demos = tcore.augment_demonstrations(demos, n_synthetic=10, seed=0)
    q, hist = tcore.pretrain_qnet(demos, steps=120, batch=4, device="cpu")
    assert len(hist["loss"]) == 3                  # steps 0, 100 and the last
    assert hist["rank_acc"][-1] > hist["rank_acc"][0]
    assert all(np.isfinite(t.numpy()).all() for t in q.values())
    srv = make()
    pol = tfl.build_policy("fedrank", qnet=q, k=3, seed=0)
    for r in srv.run(pol, rounds=2):
        assert len(set(r.selected.tolist())) == len(r.selected) <= 3
        assert set(r.selected.tolist()) <= set(r.probe_set.tolist())
    assert "expert-harmony" in tfl.available_policies()
