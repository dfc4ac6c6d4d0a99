"""The port's asynchronous engine against the JAX reference.

Both engines run on the same numpy data from the same global parameters (the
reference's arrays, copied in).  For ``fedavg`` the dispatch waves do not
depend on training numerics, so every job the engines schedule (device,
model version, dispatch order, wave, duration, energy, dropout point), every
aggregation's cohort, lags, virtual clock and energy must be exactly equal;
the global parameters agree within 1e-5 (fp32 sums in another order).
FedRank's waves read the Q-net, so they are held stage by stage: before each
wave the port is fed the reference's server and policy state (global params,
loss bookkeeping, Q-nets with their Adam state, replay items).

Also: the batched event loop equals the one-event-at-a-time oracle bit for
bit, the sync-reduction anchor (buffer = concurrency = K, always available,
constant weights) reproduces the synchronous engine, and the staleness
weights and buffered merge equal the reference's for every kind.
Small sizes only: 20 devices, a 32 -> 32 -> 10 MLP.
"""
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fl as jfl
import repro.fl.aggregation as jagg
import repro.fl.async_engine as jae
import repro_torch.data as tdata
import repro_torch.fl as tfl
import repro_torch.fl.aggregation as tagg
import repro_torch.fl.async_engine as tae
from repro_torch.convert import params_from_numpy, params_to_numpy


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _cpu(tree):
    return params_from_numpy(_np(tree), "cpu")


def _tdata(fl_data):
    return tdata.FederatedData(fl_data.train, fl_data.test, fl_data.client_indices)


def _server_pair(fl_data, **kw):
    cfg = dict(n_devices=20, k_select=3, rounds=4, l_ep=2, lr=0.1, seed=7,
               mode="async", async_concurrency=6, staleness="polynomial")
    cfg.update(kw)
    jsrv = jfl.FLServer(jfl.FLConfig(**cfg), jfl.MLPTask(dim=32, hidden=32), fl_data)
    tsrv = tfl.FLServer(tfl.FLConfig(**cfg), tfl.MLPTask(dim=32, hidden=32),
                        _tdata(fl_data), device="cpu")
    tsrv.global_params = _cpu(jsrv.global_params)
    tsrv._last_acc = jsrv._last_acc
    return jsrv, tsrv


def _record_jobs(engine):
    """Log every job the engine schedules, as it schedules it."""
    log = []
    add = engine._add_job

    def recording_add(cid, **kw):
        log.append((int(cid), engine.version, engine._seq, engine.cycle,
                    kw["duration"], kw["energy"], kw["fail_at"],
                    kw["params"] is None))
        add(cid, **kw)

    engine._add_job = recording_add
    return log


def _assert_history_equal(jh, th, acc_tol=1e-5):
    assert len(jh) == len(th)
    for jr, tr in zip(jh, th):
        assert tr.round == jr.round
        np.testing.assert_array_equal(tr.selected, jr.selected)
        np.testing.assert_array_equal(tr.failed, jr.failed)
        assert (tr.r_t, tr.r_e) == (jr.r_t, jr.r_e)
        assert (tr.cum_time, tr.cum_energy) == (jr.cum_time, jr.cum_energy)
        assert (tr.mean_staleness, tr.max_staleness) == (jr.mean_staleness,
                                                        jr.max_staleness)
        assert (tr.n_available, tr.n_pending) == (jr.n_available, jr.n_pending)
        assert abs(tr.acc - jr.acc) <= acc_tol
        assert abs(tr.test_loss - jr.test_loss) <= acc_tol


def _assert_params_close(jparams, tparams, tol):
    got, ref = params_to_numpy(tparams), _np(jparams)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol, err_msg=k)


# (scenario, staleness, events, start the round before the fleet's first
# availability change, so the clock jumps to a verified transition and
# devices go offline mid-run)
FEDAVG_CASES = [
    ("high-churn", "polynomial", "batched", False),        # churn mask + dropouts
    ("trace-synthetic-week", "hinge", "batched", False),   # trace replay transitions
    ("trace-livelab", "polynomial", "sequential", False),  # trace + 5% dropout
    ("nightly-chargers", "constant", "batched", False),    # pause/resume over gaps
    ("trace-synthetic-week", "polynomial", "batched", True),
    ("trace-livelab", "hinge", "sequential", True),
]


@pytest.mark.parametrize("scenario,staleness,events,first_change", FEDAVG_CASES,
                         ids=[c[0] + ("-first-change" if c[3] else "")
                              for c in FEDAVG_CASES])
def test_fedavg_async_equals_reference(fl_data, scenario, staleness, events,
                                       first_change):
    jsrv, tsrv = _server_pair(fl_data, scenario=scenario, staleness=staleness,
                              async_events=events)
    if first_change:
        first = tsrv.pool.next_transition()
        assert first == jsrv.pool.next_transition() and first >= 2
        for srv in (jsrv, tsrv):
            srv.pool.advance_to(first - 2)   # the engine advances one round
        n_start = int(tsrv.pool.available().sum())
        assert n_start == int(jsrv.pool.available().sum())
    jeng = jae.AsyncRoundEngine(jsrv, jfl.build_policy("fedavg"))
    teng = tae.AsyncRoundEngine(tsrv, tfl.build_policy("fedavg"))
    assert teng.tick_s == jeng.tick_s
    jlog, tlog = _record_jobs(jeng), _record_jobs(teng)
    jh, th = jeng.run(4), teng.run(4)
    if first_change:
        assert any(r.n_available != n_start for r in th)
    assert tlog == jlog                      # every wave, job by job, exactly
    _assert_history_equal(jh, th)
    assert teng.now == jeng.now and teng.version == jeng.version
    assert tsrv.pool.round_idx == jsrv.pool.round_idx
    np.testing.assert_array_equal(tsrv.loss_age, jsrv.loss_age)
    np.testing.assert_allclose(tsrv.last_loss, jsrv.last_loss, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tsrv.selection_count, jsrv.selection_count)
    _assert_params_close(jsrv.global_params, tsrv.global_params, 1e-5)
    assert all(r.executor == "sequential" for r in th)


def _snapshot(srv, pol):
    return dict(global_params=_np(srv.global_params), last_loss=srv.last_loss.copy(),
                loss_age=srv.loss_age.copy(), last_acc=srv._last_acc,
                q=_np(pol.q), q_target=_np(pol.q_target), m=_np(pol._opt_m),
                v=_np(pol._opt_v), t=int(pol._opt_t),
                replay=list(pol.replay.items), pending=pol._pending)


def _load(snap, srv, pol):
    srv.global_params = params_from_numpy(snap["global_params"], "cpu")
    srv.last_loss = snap["last_loss"].copy()
    srv.loss_age = snap["loss_age"].copy()
    srv._last_acc = snap["last_acc"]
    pol.q = params_from_numpy(snap["q"], "cpu")
    pol.q_target = params_from_numpy(snap["q_target"], "cpu")
    pol._opt_m = params_from_numpy(snap["m"], "cpu")
    pol._opt_v = params_from_numpy(snap["v"], "cpu")
    pol._opt_t = snap["t"]
    pol.replay.items = list(snap["replay"])
    pol._pending = snap["pending"]


def _wave_hooks(engine, before=None):
    """Call ``before(i)`` ahead of wave i; record each wave's probe set."""
    waves = []
    run_wave = engine._run_wave

    def hooked(ctx):
        if before is not None:
            before(len(waves))
        out = run_wave(ctx)
        waves.append(engine._last_observe[1])
        return out

    engine._run_wave = hooked
    return waves


def test_fedrank_waves_stage_by_stage(fl_data):
    jsrv, tsrv = _server_pair(fl_data, scenario="high-churn", k_select=3)
    jpol = jcore.FedRankPolicy(None, k=3, seed=0, train_batch=4,
                               train_steps_per_round=1)
    tpol = tfl.build_policy("fedrank", qnet=_cpu(jpol.q), k=3, seed=0,
                            train_batch=4, train_steps_per_round=1)
    jeng, teng = jae.AsyncRoundEngine(jsrv, jpol), tae.AsyncRoundEngine(tsrv, tpol)
    # the reference runs first, saving its state at the start of every wave
    snaps = []
    jwaves = _wave_hooks(jeng, lambda i: snaps.append(_snapshot(jsrv, jpol)))
    jlog = _record_jobs(jeng)
    jh = jeng.run(3)
    # the port starts every wave from the reference's state
    twaves = _wave_hooks(teng, lambda i: _load(snaps[i], tsrv, tpol))
    tlog = _record_jobs(teng)
    th = teng.run(3)
    assert len(twaves) == len(jwaves) >= 3
    for tw, jw in zip(twaves, jwaves):
        np.testing.assert_array_equal(tw, jw)               # probe sets
    assert tlog == jlog             # cohorts, probe exits, versions, clock
    _assert_history_equal(jh, th)
    np.testing.assert_array_equal(tsrv.selection_count, jsrv.selection_count)
    # the last merge's observe trained the Q-net from the fed state
    _assert_params_close(jpol.q, tpol.q, 1e-4)


@pytest.mark.parametrize("scenario,policy", [
    ("high-churn", "fedavg"), ("high-churn", "fedrank"),
    ("nightly-chargers", "fedavg"), ("trace-synthetic-week", "fedavg"),
    ("trace-livelab", "fedrank"),
])
def test_batched_events_equal_sequential_oracle(fl_data, scenario, policy):
    def run(events):
        cfg = tfl.FLConfig(n_devices=20, k_select=3, rounds=4, l_ep=2, lr=0.1,
                           seed=7, scenario=scenario, mode="async",
                           async_concurrency=6, staleness="polynomial",
                           async_events=events)
        srv = tfl.FLServer(cfg, tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data),
                           device="cpu")
        kw = dict(k=3, seed=7, device="cpu") if policy == "fedrank" else {}
        srv.run(tfl.build_policy(policy, **kw))
        return srv

    seq, bat = run("sequential"), run("batched")
    digest = lambda s: [(r.round, r.selected.tolist(), r.failed.tolist(), r.acc,
                         r.test_loss, r.r_t, r.cum_time, r.cum_energy,
                         r.mean_staleness, r.max_staleness, r.n_available,
                         r.n_pending) for r in s.history]
    assert digest(seq) == digest(bat)
    for k in seq.global_params:
        assert torch.equal(seq.global_params[k], bat.global_params[k]), k
    np.testing.assert_array_equal(seq.last_loss, bat.last_loss)
    np.testing.assert_array_equal(seq.loss_age, bat.loss_age)


def test_sync_reduction_anchor(fl_data):
    """buffer = concurrency = K, always available, constant weights: the
    async engine replays the synchronous engine's draws, seeds and merge."""
    kw = dict(n_devices=20, k_select=4, rounds=5, l_ep=2, lr=0.1, seed=0)
    data = _tdata(fl_data)
    sync = tfl.FLServer(tfl.FLConfig(**kw), tfl.MLPTask(dim=32, hidden=32), data,
                        device="cpu")
    asyn = tfl.FLServer(tfl.FLConfig(mode="async", **kw),
                        tfl.MLPTask(dim=32, hidden=32), data, device="cpu")
    hs, ha = sync.run(tfl.build_policy("fedavg")), asyn.run(tfl.build_policy("fedavg"))
    assert len(hs) == len(ha) == 5
    for rs, ra in zip(hs, ha):
        np.testing.assert_array_equal(rs.selected, ra.selected)
        assert abs(rs.acc - ra.acc) <= 1e-6
        assert ra.mean_staleness == 0.0 and ra.n_pending == 0
    for k in sync.global_params:
        np.testing.assert_allclose(asyn.global_params[k].numpy(),
                                   sync.global_params[k].numpy(), atol=1e-7)
    np.testing.assert_allclose(sync.last_loss, asyn.last_loss, atol=1e-6)


def test_executor_alias_matches_mode(fl_data):
    kw = dict(n_devices=20, k_select=3, rounds=3, l_ep=2, lr=0.1, seed=1,
              scenario="high-churn", async_concurrency=6)
    data = _tdata(fl_data)
    a = tfl.FLServer(tfl.FLConfig(mode="async", **kw), tfl.MLPTask(dim=32, hidden=32),
                     data, device="cpu")
    b = tfl.FLServer(tfl.FLConfig(executor="async", **kw),
                     tfl.MLPTask(dim=32, hidden=32), data, device="cpu")
    assert a.is_async and b.is_async
    ha, hb = a.run(tfl.build_policy("fedavg")), b.run(tfl.build_policy("fedavg"))
    assert [r.selected.tolist() for r in ha] == [r.selected.tolist() for r in hb]
    assert [r.cum_time for r in ha] == [r.cum_time for r in hb]
    assert hb[0].executor == "async[sequential]" and ha[0].executor == "sequential"


def test_async_executor_registry():
    assert "async" in tfl.available_executors()
    ex = tfl.make_executor("async")
    assert isinstance(ex, tfl.AsyncDispatchExecutor)
    assert tfl.executor_label(ex) == jfl.executor_label(jfl.make_executor("async"))
    vm = tfl.make_executor("async", inner="vmapped")
    assert isinstance(vm.inner, tfl.VmappedExecutor)
    assert tfl.executor_label(vm) == jfl.executor_label(
        jfl.make_executor("async", inner="vmapped"))


@pytest.mark.parametrize("bad,match", [
    (dict(buffer_size=4, async_concurrency=2), "async_concurrency"),
    (dict(staleness="exponential"), "staleness"),
    (dict(async_events="parallel"), "async_events"),
])
def test_bad_async_config_raises(fl_data, bad, match):
    cfg = tfl.FLConfig(n_devices=20, k_select=3, rounds=1, l_ep=1, seed=0,
                       mode="async", **bad)
    srv = tfl.FLServer(cfg, tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data),
                       device="cpu")
    with pytest.raises(ValueError, match=match):
        srv.run(tfl.build_policy("fedavg"))


def test_round_result_async_fields_default_for_sync(fl_data):
    cfg = tfl.FLConfig(n_devices=20, k_select=3, rounds=1, l_ep=1, seed=0)
    srv = tfl.FLServer(cfg, tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data),
                       device="cpu")
    r = srv.run_round(tfl.build_policy("fedavg"))
    assert (r.mean_staleness, r.max_staleness, r.n_pending) == (0.0, 0, 0)


def test_event_groups_equal_reference():
    rng = np.random.default_rng(0)
    times = np.sort(np.concatenate([rng.uniform(0, 10, 50),
                                    np.repeat(rng.uniform(0, 10, 5), 3) + 1e-10]))
    assert tae.event_groups(times) == jae.event_groups(times)
    assert tae.event_groups(np.zeros(0)) == []


def test_job_table_matches_reference_under_pause_resume():
    tt, jt = tae._JobTable(capacity=2), jae._JobTable(capacity=2)
    for tab, kw in ((tt, {}), (jt, {"adversarial": False})):
        for cid in range(5):            # grows past its capacity
            tab.add(cid=cid, version=0, seq=cid, cycle=0, duration=10.0 + cid,
                    energy=1.0, fail_at=np.inf if cid != 3 else 4.0, now=1.0,
                    payload=(None if cid == 2 else {}, 0.5), **kw)
        mask = np.array([True, False, True, False, True])
        tab.apply_mask(mask, 3.0)
        tab.apply_mask(np.ones(5, bool), 7.5)
        tab.free(0)
    np.testing.assert_array_equal(tt.end_abs(), jt.end_abs())
    assert len(tt) == len(jt) == 4


@pytest.mark.parametrize("kind", ["constant", "polynomial", "hinge"])
def test_staleness_weight_equal(kind):
    lags = np.array([0, 1, 2, 3, 4, 5, 8, 20])
    for a, b in ((0.5, 4), (1.0, 2), (0.25, 0)):
        np.testing.assert_array_equal(
            tagg.staleness_weight(lags, kind, a=a, b=b),
            jagg.staleness_weight(lags, kind, a=a, b=b))


def _toy_params(seed):
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(size=(5, 4)).astype(np.float32),
            "b1": rng.normal(size=(4,)).astype(np.float32)}


@pytest.mark.parametrize("kind", ["constant", "polynomial", "hinge"])
def test_buffered_aggregate_equal(kind):
    g = _toy_params(0)
    clients = [_toy_params(s) for s in (1, 2, 3, 4)]
    weights, lags = [30.0, 10.0, 25.0, 5.0], [0, 2, 5, 9]
    got = tagg.buffered_aggregate(_cpu(g), [_cpu(c) for c in clients], weights,
                                  lags, kind=kind, a=0.5, b=4)
    want = jagg.buffered_aggregate(g, clients, weights, lags, kind=kind, a=0.5, b=4)
    _assert_params_close(want, got, 1e-6)
    if kind == "constant":            # exactly fedavg of the buffer
        avg = tagg.fedavg([_cpu(c) for c in clients], weights)
        for k in avg:
            assert torch.equal(got[k], avg[k])


def test_buffered_aggregate_refuses_robust_kinds():
    """Unknown robust and staleness kinds are refused as in the reference;
    the robust kinds themselves are held to it in test_torch_attacks."""
    g = _cpu(_toy_params(0))
    with pytest.raises(ValueError, match="aggregator"):
        tagg.buffered_aggregate(g, [g], [1.0], [0], robust="bulyan")
    with pytest.raises(ValueError, match="staleness"):
        tagg.staleness_weight([0], "exponential")


def test_expected_staleness_equal(fl_data):
    jsrv, tsrv = _server_pair(fl_data, scenario="high-churn")
    jfl_pol, tfl_pol = jfl.build_policy("fedavg"), tfl.build_policy("fedavg")
    jae.AsyncRoundEngine(jsrv, jfl_pol).run(3)
    tae.AsyncRoundEngine(tsrv, tfl_pol).run(3)
    ids = np.arange(20)
    np.testing.assert_array_equal(tsrv._ctx().expected_staleness(ids),
                                  jsrv._ctx().expected_staleness(ids))
    fallback = jsrv._static_round_estimates()[0][ids]
    np.testing.assert_array_equal(tsrv.telemetry.feature_block(ids, fallback),
                                  jsrv.telemetry.feature_block(ids, fallback))
