"""The port's attacks and Byzantine-robust aggregation against the JAX reference.

* Attacks: every model's static ``adversary_mask``, per-round ``draw`` and
  ``corrupt`` on the same params.  Membership and draws are numpy streams, so
  they are exactly equal; ``GaussianNoise`` draws its noise leaf by leaf in
  the reference's (sorted-name) order and is exactly equal too; the other
  corruptions are fp32 arithmetic on the delta, within 1e-6.
* Reducers: ``trimmed_mean``, ``coordinate_median``, ``krum`` /
  ``multi_krum`` (and ``krum_scores``) through ``robust_aggregate`` on the
  same stacks, with tied values (duplicated clients, quantised values), an
  even count for the median, and ``trim`` / ``f`` at and past their clips:
  values within 1e-6 (fp32 sums in another order); Krum's pick and
  Multi-Krum's set exactly equal, scores within 1e-9 relative (fp64 sums in
  another order).  ``compose_staleness`` exactly equal, and
  ``buffered_aggregate(robust=...)`` within 1e-6 for every staleness kind.
* Runs on ``byzantine-signflip`` with ``fedavg`` and ``krum``, sync (the
  reference's global params fed in before every round) and async: adversary
  sets, cohorts, failures and the clock exactly equal, params within 1e-5.

Small sizes only: 20 devices, a 32 -> 32 -> 10 MLP.
"""
import numpy as np
import pytest
import torch

import repro.fl as jfl
import repro.fl.aggregation as jagg
import repro.fl.attacks as jatk
import repro_torch.data as tdata
import repro_torch.fl as tfl
import repro_torch.fl.aggregation as tagg
import repro_torch.fl.attacks as tatk
from repro_torch.convert import params_from_numpy, params_to_numpy


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _cpu(tree):
    return params_from_numpy(_np(tree), "cpu")


def _tdata(fl_data):
    return tdata.FederatedData(fl_data.train, fl_data.test, fl_data.client_indices)


def _assert_close(ref, got, tol):
    ref, got = _np(ref), params_to_numpy(got)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol, err_msg=k)


def _mlp_params(seed, scale=1.0):
    """A 32 -> 32 -> 10 MLP's leaves, in the port's insertion order."""
    rng = np.random.default_rng(seed)
    shapes = {"w1": (32, 32), "b1": (32,), "w2": (32, 32), "b2": (32,),
              "w3": (32, 10), "b3": (10,)}
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


ATTACKS = {
    "base": (jatk.AttackModel(0.0), tatk.AttackModel(0.0)),
    "signflip": (jatk.SignFlip(fraction=0.3, scale=4.0),
                 tatk.SignFlip(fraction=0.3, scale=4.0)),
    "scaled": (jatk.ScaledUpdate(fraction=0.2, factor=10.0),
               tatk.ScaledUpdate(fraction=0.2, factor=10.0)),
    "noise": (jatk.GaussianNoise(fraction=0.25, sigma=0.5),
              tatk.GaussianNoise(fraction=0.25, sigma=0.5)),
    "label-drift": (jatk.LabelSkewDrift(fraction=0.3, period=2),
                    tatk.LabelSkewDrift(fraction=0.3, period=2)),
}


@pytest.mark.parametrize("name", sorted(ATTACKS))
def test_attack_matches_reference(name):
    ja, ta = ATTACKS[name]
    for n, seed in ((20, 0), (37, 5), (1000, 3)):
        np.testing.assert_array_equal(ta.adversary_mask(n, seed),
                                      ja.adversary_mask(n, seed))
        ids = np.random.default_rng(n).choice(n, size=min(n, 12), replace=False)
        for rnd in (0, 1, 7):
            np.testing.assert_array_equal(ta.draw(n, seed, rnd, ids),
                                          ja.draw(n, seed, rnd, ids))
    g, p = _mlp_params(1), _mlp_params(2)
    for cid, rnd in ((3, 0), (3, 1), (11, 2), (11, 5)):
        want = ja.corrupt(p, g, cid=cid, seed=7, round_idx=rnd)
        got = ta.corrupt(_cpu(p), _cpu(g), cid=cid, seed=7, round_idx=rnd)
        assert list(got) == list(p)                    # leaf order kept
        if name == "noise":
            for k in p:
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), k)
        else:
            _assert_close(want, got, 1e-6)


def test_attack_rng_and_validation_match_reference():
    for args in ((0, -1), (3, 4, 9), (-2, 0, -1)):
        np.testing.assert_array_equal(tatk.attack_rng(*args).random(5),
                                      jatk.attack_rng(*args).random(5))
    with pytest.raises(ValueError, match="fraction"):
        tatk.SignFlip(fraction=1.5)
    with pytest.raises(ValueError, match="period"):
        tatk.LabelSkewDrift(fraction=0.1, period=0)
    drift = tatk.LabelSkewDrift(period=2)
    assert [drift.shift(r, 10) for r in range(6)] == [0, 0, 1, 1, 2, 2]


def _stack(m, seed, *, ties=False):
    """m client updates; with ``ties`` values quantised to 0.25 and the last
    two clients equal, so ranks, medians and Krum scores tie."""
    clients = [_mlp_params(seed + i, 0.5) for i in range(m)]
    if ties:
        clients = [{k: np.round(v * 4) / 4 for k, v in c.items()} for c in clients]
        clients[-1] = {k: v.copy() for k, v in clients[-2].items()}
    weights = np.random.default_rng(seed).integers(5, 200, size=m).astype(np.float64)
    return clients, weights


REDUCER_CASES = [
    # (kind, m, knobs): trim at its clip ((m-1)//2) and past it, f past
    # (m-3)//2, m_select past m
    ("mean", 5, {}),
    ("trimmed_mean", 5, dict(trim=0)),
    ("trimmed_mean", 5, dict(trim=1)),
    ("trimmed_mean", 6, dict(trim=2)),
    ("trimmed_mean", 6, dict(trim=9)),
    ("coordinate_median", 5, {}),
    ("coordinate_median", 6, {}),
    ("coordinate_median", 2, {}),
    ("krum", 7, dict(f=1)),
    ("krum", 7, dict(f=2)),
    ("krum", 7, dict(f=9)),
    ("krum", 3, dict(f=1)),
    ("multi_krum", 7, dict(f=2)),
    ("multi_krum", 7, dict(f=1, m_select=3)),
    ("multi_krum", 6, dict(f=5, m_select=100)),
]


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("kind,m,knobs", REDUCER_CASES,
                         ids=[f"{k}-m{m}-{'-'.join(f'{a}{b}' for a, b in kn.items())}"
                              for k, m, kn in REDUCER_CASES])
def test_robust_aggregate_matches_reference(kind, m, knobs, ties):
    clients, weights = _stack(m, 10 + m, ties=ties)
    want = jagg.robust_aggregate(clients, weights, kind=kind, **knobs)
    got = tagg.robust_aggregate([_cpu(c) for c in clients], weights, kind=kind,
                                **knobs)
    _assert_close(want, got, 1e-6)
    if kind in ("krum", "multi_krum"):
        f = knobs.get("f", 1)
        js = jagg.krum_scores(clients, f=f)
        ts = tagg.krum_scores([_cpu(c) for c in clients], f=f)
        np.testing.assert_allclose(ts, js, rtol=1e-9, atol=0)
        assert int(np.argmin(ts)) == int(np.argmin(js))
        np.testing.assert_array_equal(np.argsort(ts, kind="stable"),
                                      np.argsort(js, kind="stable"))


def test_reducers_called_directly_match_reference():
    clients, weights = _stack(6, 3, ties=True)
    tc = [_cpu(c) for c in clients]
    _assert_close(jagg.trimmed_mean(clients, weights, trim=2),
                  tagg.trimmed_mean(tc, weights, trim=2), 1e-6)
    _assert_close(jagg.coordinate_median(clients), tagg.coordinate_median(tc), 1e-6)
    _assert_close(jagg.krum(clients, f=1), tagg.krum(tc, f=1), 0)
    _assert_close(jagg.multi_krum(clients, weights, f=1),
                  tagg.multi_krum(tc, weights, f=1), 1e-6)
    # trim=0 is fedavg itself; an even median averages the middle pair
    zero = tagg.trimmed_mean(tc, weights, trim=0)
    avg = tagg.fedavg(tc, weights)
    assert all(torch.equal(zero[k], avg[k]) for k in avg)
    pair = tagg.coordinate_median([_cpu({"w": np.array([1.0, 4.0], np.float32)}),
                                   _cpu({"w": np.array([2.0, 8.0], np.float32)})])
    np.testing.assert_array_equal(pair["w"].numpy(), [1.5, 6.0])
    with pytest.raises(ValueError, match="trim"):
        tagg.trimmed_mean(tc, weights, trim=3)
    with pytest.raises(ValueError, match="aggregator"):
        tagg.robust_aggregate(tc, weights, kind="geometric_median")


def test_compose_staleness_matches_reference():
    region = np.array([0, 1, 3, 6, 10])
    root = np.array([0, 2, 0, 5, 1])
    for kind in tagg.STALENESS_KINDS:
        for tiers in ([region], [region, root], [region, root, root[::-1]]):
            np.testing.assert_array_equal(
                tagg.compose_staleness(tiers, kind, a=0.5, b=2),
                jagg.compose_staleness(tiers, kind, a=0.5, b=2))
    assert (tagg.compose_staleness([np.zeros(3), np.zeros(3)], "polynomial") == 1).all()
    with pytest.raises(ValueError, match="tier"):
        tagg.compose_staleness([])


@pytest.mark.parametrize("robust", ["trimmed_mean", "coordinate_median", "krum",
                                    "multi_krum"])
@pytest.mark.parametrize("kind", ["constant", "polynomial", "hinge"])
def test_buffered_aggregate_robust_matches_reference(kind, robust):
    g = _mlp_params(0)
    clients, weights = _stack(7, 20)
    lags = [0, 1, 3, 6, 0, 2, 9]
    knobs = dict(trim=2, f=2, m_select=4)
    want = jagg.buffered_aggregate(g, clients, weights, lags, kind=kind, a=0.5,
                                   b=2, robust=robust, **knobs)
    got = tagg.buffered_aggregate(_cpu(g), [_cpu(c) for c in clients], weights,
                                  lags, kind=kind, a=0.5, b=2, robust=robust,
                                  **knobs)
    _assert_close(want, got, 1e-6)


# ---------------------------------------------------------------------------
# whole runs on byzantine-signflip
# ---------------------------------------------------------------------------


def _servers(fl_data, **kw):
    cfg = dict(n_devices=20, k_select=5, rounds=3, l_ep=2, lr=0.1, seed=2,
               scenario="byzantine-signflip")
    cfg.update(kw)
    jsrv = jfl.FLServer(jfl.FLConfig(**cfg), jfl.MLPTask(dim=32, hidden=32), fl_data)
    tsrv = tfl.FLServer(tfl.FLConfig(**cfg), tfl.MLPTask(dim=32, hidden=32),
                        _tdata(fl_data), device="cpu")
    tsrv.global_params = _cpu(jsrv.global_params)
    tsrv._last_acc = jsrv._last_acc
    return jsrv, tsrv


def _assert_result_equal(jr, tr):
    np.testing.assert_array_equal(tr.selected, jr.selected)
    np.testing.assert_array_equal(tr.adversaries, jr.adversaries)
    np.testing.assert_array_equal(tr.failed, jr.failed)
    assert (tr.r_t, tr.r_e, tr.cum_time, tr.cum_energy) == (
        jr.r_t, jr.r_e, jr.cum_time, jr.cum_energy)
    assert (tr.mean_staleness, tr.n_available) == (jr.mean_staleness, jr.n_available)
    assert abs(tr.acc - jr.acc) <= 1e-5


@pytest.mark.parametrize("aggregator", ["mean", "krum"])
def test_signflip_sync_rounds_match_reference(fl_data, aggregator):
    jsrv, tsrv = _servers(fl_data, aggregator=aggregator, agg_f=1)
    assert isinstance(tsrv.attack, tatk.SignFlip)
    jpol, tpol = jfl.build_policy("fedavg"), tfl.build_policy("fedavg")
    seen = 0
    for _ in range(3):
        tsrv.global_params = _cpu(jsrv.global_params)
        tsrv._last_acc = jsrv._last_acc
        jr, tr = jsrv.run_round(jpol), tsrv.run_round(tpol)
        _assert_result_equal(jr, tr)
        _assert_close(jsrv.global_params, tsrv.global_params, 1e-5)
        seen += len(tr.adversaries)
    assert seen > 0
    mask = tsrv.attack.adversary_mask(20, 2)
    assert mask[np.concatenate([r.adversaries for r in tsrv.history])].all()


@pytest.mark.parametrize("aggregator", ["mean", "krum"])
def test_signflip_async_matches_reference(fl_data, aggregator):
    jsrv, tsrv = _servers(fl_data, aggregator=aggregator, agg_f=1, mode="async",
                          async_concurrency=10, staleness="polynomial")
    jh = jsrv.run(jfl.build_policy("fedavg"))
    th = tsrv.run(tfl.build_policy("fedavg"))
    assert len(jh) == len(th) == 3
    for jr, tr in zip(jh, th):
        _assert_result_equal(jr, tr)
    assert sum(len(r.adversaries) for r in th) > 0
    _assert_close(jsrv.global_params, tsrv.global_params, 1e-5)


def test_config_attack_overrides_the_scenario(fl_data):
    noise = tatk.GaussianNoise(fraction=0.5, sigma=0.1)
    _, tsrv = _servers(fl_data, attack=noise)
    assert tsrv.attack is noise
    _, plain = _servers(fl_data, scenario="uniform")
    assert plain.attack is None
    res = plain.run_round(tfl.build_policy("fedavg"))
    assert res.adversaries.size == 0
