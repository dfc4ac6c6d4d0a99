"""The port's baseline policies against the JAX reference, on the CPU.

Each policy of both packages sees the same hand-built round contexts: the
same system state, bookkeeping, availability, device telemetry and a numpy
generator from the same seed.  Probe sets and cohorts must be exactly equal
round after round, and the policies' own state (TiFL's tiers and gains,
Favor's exploration rate) must follow the reference's.  Favor's Q-net starts
from the reference's arrays; its TD step (autograd, plain SGD) agrees within
1e-5 (fp32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro.core.features as jfeat
import repro.fl as jfl
import repro.fl.server as jserver
import repro.fl.simulation as jsim
import repro.fl.telemetry as jtel
import repro_torch.core as tcore
import repro_torch.core.features as tfeat
import repro_torch.fl as tfl
import repro_torch.fl.server as tserver
import repro_torch.fl.simulation as tsim
import repro_torch.fl.telemetry as ttel
from repro_torch.convert import params_from_numpy, params_to_numpy

N, K = 40, 4


def _telemetry(rng, n):
    """Both packages' telemetry fed the same observations."""
    jt, tt = jtel.DeviceTelemetry(n), ttel.DeviceTelemetry(n)
    for _ in range(3):
        mask = rng.random(n) > 0.25
        sel = rng.permutation(n)[:8]
        dur = rng.lognormal(3.0, 0.5, 8)
        lags = rng.integers(0, 3, 6).astype(float)
        for t in (jt, tt):
            t.observe_availability(mask)
            t.observe_selection(sel)
            t.observe_dropouts(sel[:1])
            t.observe_stragglers(sel[1:2])
            t.observe_completions(sel[2:], dur[2:])
            t.observe_staleness(sel[2:], lags)
            t.observe_cadence(float(dur.max()))
    return jt, tt


def _contexts(seed, rnd, rngs, telemetry):
    """(reference ctx, port ctx) for round ``rnd``; ``rngs`` are the two
    policies' generators (one stream each, same seed)."""
    rng = np.random.default_rng(1000 * seed + rnd)
    sys = dict(t_comp=rng.lognormal(1.0, 1.0, N), t_comm=rng.lognormal(0.5, 1.0, N),
               e_comp=rng.lognormal(0.0, 1.0, N), e_comm=rng.lognormal(-1.0, 1.0, N),
               load=rng.uniform(0.5, 1.0, N))
    est_t = rng.lognormal(3.0, 1.0, N)
    est_t[:6] = est_t[6]                        # latency ties for TiFL's tiers
    common = dict(
        round=rnd, n=N, k=K, est_t_round=est_t,
        est_e_round=rng.lognormal(2.0, 1.0, N),
        data_sizes=rng.integers(20, 300, N),
        last_loss=rng.uniform(0.1, 3.0, N),
        loss_age=rng.integers(0, 6, N).astype(float),
        available=rng.random(N) > 0.2,
        selection_count=rng.integers(0, 5, N))
    jt, tt = telemetry
    jctx = jserver.RoundContext(sys=jsim.RoundSystemState(**sys), telemetry=jt,
                                feature_set=jfeat.get_feature_set("paper6"),
                                rng=rngs[0], **common)
    tctx = tserver.RoundContext(sys=tsim.RoundSystemState(**sys), telemetry=tt,
                                feature_set=tfeat.get_feature_set("paper6"),
                                rng=rngs[1], **common)
    return jctx, tctx


def _results(rnd, selected, d_acc, reward):
    kw = dict(round=rnd, selected=selected, probe_set=np.empty(0, np.int64),
              acc=0.5, test_loss=1.0, r_t=10.0, r_e=5.0, d_acc=d_acc,
              reward=reward, cum_time=10.0, cum_energy=5.0)
    return jserver.RoundResult(**kw), tserver.RoundResult(**kw)


def _run_rounds(jpol, tpol, seed, rounds=4, telemetry=True, after_observe=None):
    rngs = (np.random.default_rng(seed), np.random.default_rng(seed))
    tel = (_telemetry(np.random.default_rng(seed), N) if telemetry
           else (None, None))
    cohorts = []
    for rnd in range(rounds):
        jctx, tctx = _contexts(seed, rnd, rngs, tel)
        jprobe = tprobe = jstates = tstates = None
        assert tpol.needs_probing == jpol.needs_probing
        if jpol.needs_probing:
            jprobe, tprobe = jpol.probe_set(jctx), tpol.probe_set(tctx)
            np.testing.assert_array_equal(tprobe, jprobe)
            losses = np.random.default_rng(rnd).uniform(0.1, 3.0, len(jprobe))
            jstates = jctx.probe_states(jprobe, losses)
            tstates = tctx.probe_states(tprobe, losses)
            np.testing.assert_array_equal(tstates, jstates)
        jsel = np.asarray(jpol.select(jctx, jprobe, jstates))
        tsel = np.asarray(tpol.select(tctx, tprobe, tstates))
        np.testing.assert_array_equal(tsel, jsel)
        assert len(set(tsel.tolist())) == len(tsel) <= K
        assert tctx.available[tsel].all()
        jres, tres = _results(rnd, jsel, d_acc=0.01 * (rnd - 1), reward=0.1 * rnd)
        jpol.observe(jctx, jres, jprobe, jstates)
        tpol.observe(tctx, tres, tprobe, tstates)
        if after_observe is not None:
            after_observe(jpol, tpol)
        cohorts.append(tsel)
    # both generators were drawn from alike
    assert rngs[0].random() == rngs[1].random()
    return cohorts


@pytest.mark.parametrize("name", ["afl", "tifl", "oort", "oort-telemetry",
                                  "fedmarl", "expert-oort", "expert-harmony",
                                  "expert-fedmarl", "fedavg"])
@pytest.mark.parametrize("seed", [0, 3])
def test_cohorts_exactly_equal(name, seed):
    jpol, tpol = jfl.build_policy(name), tfl.build_policy(name)
    assert tpol.name == jpol.name
    _run_rounds(jpol, tpol, seed)
    if name == "tifl":
        np.testing.assert_array_equal(tpol.tier_of, jpol.tier_of)
        np.testing.assert_array_equal(tpol.credits, jpol.credits)
        np.testing.assert_array_equal(tpol.tier_gain, jpol.tier_gain)


def test_oort_telemetry_without_history_is_oort():
    """With no telemetry on the context the telemetry-aware utility reduces to
    plain Oort, in the port as in the reference."""
    a = _run_rounds(jfl.build_policy("oort"), tfl.build_policy("oort-telemetry"),
                    seed=5, telemetry=False)
    b = _run_rounds(jfl.build_policy("oort-telemetry"), tfl.build_policy("oort"),
                    seed=5, telemetry=False)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _feed_favor(jpol, tpol):
    tpol.q = params_from_numpy({k: np.asarray(v) for k, v in jpol.q.items()}, "cpu")
    tpol.q_target = params_from_numpy(
        {k: np.asarray(v) for k, v in jpol.q_target.items()}, "cpu")


@pytest.mark.parametrize("eps", [None, 0.0], ids=["explore", "greedy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_favor_cohorts_and_td_steps(seed, eps):
    """Default exploration mixes random and greedy rounds; ``eps=0`` makes
    every cut the fused Q-net scoring + top-K over the fleet."""
    jpol, tpol = jcore.FavorPolicy(seed=0), tfl.build_policy("favor", device="cpu")
    if eps is not None:
        jpol.eps = tpol.eps = eps
    _feed_favor(jpol, tpol)

    def check(jp, tp):
        for k, v in jp.q.items():
            np.testing.assert_allclose(params_to_numpy(tp.q)[k], np.asarray(v),
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        assert tp._steps == jp._steps and tp.eps == jp.eps
        _feed_favor(jp, tp)        # stage by stage: next round from the same net

    _run_rounds(jpol, tpol, seed, rounds=5, after_observe=check)
    assert jpol._steps == tpol._steps == 4


def test_favor_td_step_within_tolerance():
    """One TD step from the same net and the same transition: the updated
    Q-net within 1e-5, every entry of it moved."""
    jpol, tpol = jcore.FavorPolicy(seed=4), tfl.build_policy("favor", device="cpu")
    _feed_favor(jpol, tpol)
    rng = np.random.default_rng(8)
    feats = jfeat.featurize(rng.lognormal(1.0, 1.0, (N, 6)))
    act = np.zeros(N, np.float32)
    act[rng.permutation(N)[:K]] = 1.0
    target = np.float32(0.7)
    _, g = jpol._grad(jpol.q, jnp.asarray(feats), jnp.asarray(act),
                      jnp.asarray(target, jnp.float32))
    jq = {k: np.asarray(jpol.q[k] - jpol.lr * g[k]) for k in jpol.q}
    q0 = params_to_numpy(tpol.q)
    tpol._td_step(feats, act, target)
    tq = params_to_numpy(tpol.q)
    for k in jq:
        np.testing.assert_allclose(tq[k], jq[k], rtol=1e-5, atol=1e-5, err_msg=k)
    assert all(np.any(tq[k] != q0[k]) for k in tq)


def test_new_policies_are_registered():
    names = set(tfl.available_policies())
    assert {"afl", "tifl", "oort", "oort-telemetry", "favor", "fedmarl",
            "expert-oort", "expert-harmony", "expert-fedmarl"} <= names
    assert names == set(jfl.available_policies())
    assert isinstance(tfl.build_policy("expert-oort"), tcore.ExpertPolicy)
    assert tfl.build_policy("favor", device="cpu").q["w1"].device.type == "cpu"
