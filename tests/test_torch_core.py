"""The port's FedRank core against the JAX reference, on the CPU.

Featurization and the replay buffer's sampling are numpy in both packages and
must be exactly equal; the Q-net forward agrees within 1e-5 and one double-Q
train step (loss and updated params) within 1e-5 (fp32 sums in another
order, the same inline Adam).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.dqn as jdqn
import repro.core.features as jfeat
import repro.core.qnet as jqnet
import repro.core.ranking as jrank
import repro.fl.telemetry as jtel
import repro_torch.core.dqn as tdqn
import repro_torch.core.features as tfeat
import repro_torch.core.qnet as tqnet
import repro_torch.core.ranking as trank
import repro_torch.fl.telemetry as ttel
from repro_torch.convert import params_from_numpy, params_to_numpy


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _raw_states(rng, m, width):
    cols = [rng.lognormal(3.0, 1.2, m), rng.lognormal(2.0, 1.0, m),
            rng.lognormal(1.0, 1.2, m), rng.lognormal(0.0, 1.0, m),
            rng.uniform(0.05, 3.0, m), rng.lognormal(5.0, 0.8, m)]
    cols += [rng.lognormal(0.5, 1.0, m) for _ in range(width - 6)]
    return np.stack(cols, axis=1)


@pytest.mark.parametrize("name,m", [("paper6", 25), ("paper6", 1000),
                                    ("telemetry", 64)])
def test_featurize_exactly_equal(name, m):
    rng = np.random.default_rng(m)
    jfs, tfs = jfeat.get_feature_set(name), tfeat.get_feature_set(name)
    assert (jfs.state_dim, jfs.feature_dim) == (tfs.state_dim, tfs.feature_dim)
    states = _raw_states(rng, m, jfs.state_dim)
    np.testing.assert_array_equal(tfs.featurize(states), jfs.featurize(states))


def test_telemetry_feature_block_exactly_equal():
    rng = np.random.default_rng(1)
    n = 30
    jt, tt = jtel.DeviceTelemetry(n), ttel.DeviceTelemetry(n)
    for _ in range(4):
        mask = rng.random(n) > 0.3
        sel = rng.permutation(n)[:6]
        dur = rng.lognormal(3.0, 0.5, 6)
        for t in (jt, tt):
            t.observe_availability(mask)
            t.observe_selection(sel)
            t.observe_dropouts(sel[:1])
            t.observe_stragglers(sel[1:2])
            t.observe_completions(sel[2:], dur[2:])
            t.observe_staleness(sel[2:], np.zeros(4))
            t.observe_cadence(float(dur.max()))
    ids = np.arange(n)
    fallback = rng.lognormal(3.0, 0.5, n)
    np.testing.assert_array_equal(tt.feature_block(ids, fallback),
                                  jt.feature_block(ids, fallback))
    assert ttel.TELEMETRY_FEATURES == jtel.TELEMETRY_FEATURES


@pytest.mark.parametrize("in_dim,shape", [(6, (25,)), (14, (4, 64))])
def test_apply_qnet_matches(in_dim, shape):
    jq = jqnet.init_qnet(jax.random.PRNGKey(in_dim), in_dim=in_dim)
    tq = params_from_numpy(_np(jq), "cpu")
    feats = np.random.default_rng(2).normal(size=shape + (in_dim,)).astype(np.float32)
    np.testing.assert_allclose(
        tqnet.apply_qnet(tq, torch.as_tensor(feats)).numpy(),
        np.asarray(jqnet.apply_qnet(jq, jnp.asarray(feats))), rtol=1e-5, atol=1e-5)


def test_init_qnet_layout_and_seed():
    a = params_to_numpy(tqnet.init_qnet(3, in_dim=14, device="cpu"))
    b = params_to_numpy(tqnet.init_qnet(3, in_dim=14, device="cpu"))
    ref = _np(jqnet.init_qnet(jax.random.PRNGKey(3), in_dim=14))
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in ref.items()}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])      # same seed, same weights
    assert np.abs(a["w2"]).max() <= 2.0 / np.sqrt(64) + 1e-7


def test_pairwise_bce_matches():
    rng = np.random.default_rng(3)
    s = rng.normal(size=40).astype(np.float32)
    t = rng.normal(size=40).astype(np.float32)
    m = (rng.random(40) > 0.3).astype(np.float32)
    ref = jrank.pairwise_bce(jnp.asarray(s), jrank.pairwise_soft_targets(
        jnp.asarray(t)), jnp.asarray(m))
    got = trank.pairwise_bce(torch.as_tensor(s), trank.pairwise_soft_targets(
        torch.as_tensor(t)), torch.as_tensor(m))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m,f", [(1, 6), (25, 6), (64, 14)])
def test_pad_cohort_equal(m, f):
    feats = np.random.default_rng(m).normal(size=(m, f)).astype(np.float32)
    for ref, got in zip(jdqn.pad_cohort(feats), tdqn.pad_cohort(feats)):
        np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="MAX_COHORT"):
        tdqn.pad_cohort(np.zeros((tdqn.MAX_COHORT + 1, f), np.float32))


def _transitions(rng, n_tr, f, k):
    trs = []
    for r in range(n_tr):
        m, m2 = int(rng.integers(k + 1, 30)), int(rng.integers(3, 30))
        pf, pmask = jdqn.pad_cohort(rng.normal(size=(m, f)).astype(np.float32))
        nf, nmask = jdqn.pad_cohort(rng.normal(size=(m2, f)).astype(np.float32))
        action = np.zeros(jdqn.MAX_COHORT, np.float32)
        action[rng.permutation(m)[:k]] = 1.0
        trs.append((pf, pmask, action, float(rng.normal()), nf, nmask, k))
    return trs


@pytest.mark.parametrize("rank_eps", [0.5, 0.0])
def test_td_train_step_matches(rank_eps):
    rng = np.random.default_rng(4)
    k, f = 5, 6
    raw = _transitions(rng, 6, f, k)
    jq = jqnet.init_qnet(jax.random.PRNGKey(0))
    jqt = jqnet.init_qnet(jax.random.PRNGKey(1))
    jm = jax.tree.map(jnp.zeros_like, jq)
    jv = jax.tree.map(jnp.zeros_like, jq)
    jstep = jdqn.make_td_train_step(0.9, rank_eps, k, 5e-4)
    jbatch = jdqn.batch_transitions([jdqn.Transition(*t) for t in raw])
    jq2, jm2, jv2, jt2, jloss, jaux = jstep(jq, jqt, jm, jv,
                                            jnp.zeros((), jnp.int32), jbatch)

    tq = params_from_numpy(_np(jq), "cpu")
    tqt = params_from_numpy(_np(jqt), "cpu")
    tm = {n: torch.zeros_like(v) for n, v in tq.items()}
    tv = {n: torch.zeros_like(v) for n, v in tq.items()}
    tstep = tdqn.make_td_train_step(0.9, rank_eps, k, 5e-4)
    tbatch = tdqn.batch_transitions([tdqn.Transition(*t) for t in raw],
                                    torch.device("cpu"))
    tq2, tm2, tv2, tt2, tloss, taux = tstep(tq, tqt, tm, tv, 0, tbatch)

    assert tt2 == int(jt2) == 1
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-5)
    for name in ("l_rl", "l_rank"):
        np.testing.assert_allclose(float(taux[name]), float(jaux[name]),
                                   rtol=1e-5, atol=1e-5)
    for ref, got in ((jq2, tq2), (jm2, tm2), (jv2, tv2)):
        ref, got = _np(ref), params_to_numpy(got)
        for n in ref:
            np.testing.assert_allclose(got[n], ref[n], rtol=1e-5, atol=1e-5,
                                       err_msg=n)


def test_replay_buffer_sampling_exactly_equal():
    jb, tb = jdqn.ReplayBuffer(capacity=20, seed=3), tdqn.ReplayBuffer(capacity=20, seed=3)
    for r in range(30):                      # overflows the capacity
        for buf, mod in ((jb, jdqn), (tb, tdqn)):
            buf.add(mod.Transition(None, None, None, float(r), None, None, k=1))
        for n in (1, 4, 8):
            assert ([t.reward for t in jb.sample(n)]
                    == [t.reward for t in tb.sample(n)])
    assert len(jb) == len(tb) == 20
