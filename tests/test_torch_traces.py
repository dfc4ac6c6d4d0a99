"""The port's trace layer against the JAX reference, on the same inputs.

Compilation, CSV ingestion and emission, the synthetic generator, bootstrap
resampling, the next-flip tables and ``next_transition`` must equal the
reference's exactly (they are numpy on the host, or exact segment counts).
Trace scenarios build the same fleets, and synchronous rounds on them pick
the same cohorts with the same virtual clock.  Small sizes only.
"""
import filecmp

import numpy as np
import pytest

import repro.fl as jfl
import repro.fl.traces as jtr
import repro_torch.data as tdata
import repro_torch.fl as tfl
import repro_torch.fl.traces as ttr
from repro_torch.convert import params_from_numpy

DAY = 86400.0


def _events(seed, n_dev=6, max_events=15, period=2 * DAY, same_instant=True):
    rng = np.random.default_rng(seed)
    ev = {}
    for d in range(n_dev):
        k = int(rng.integers(1, max_events + 1))
        t = rng.integers(0, int(period), size=k).astype(float)
        if same_instant and k > 2:
            t[1] = t[0]                       # a same-instant pair
        ev[f"dev{d}"] = [(float(x), int(rng.integers(0, 4))) for x in t]
    return ev


def _assert_trace_equal(tt, jt):
    assert tt.device_ids == jt.device_ids
    assert tt.period_s == jt.period_s
    np.testing.assert_array_equal(tt.offsets, jt.offsets)
    np.testing.assert_array_equal(tt.t_start, jt.t_start)
    np.testing.assert_array_equal(tt.state, jt.state)
    assert tt.state.dtype == jt.state.dtype and tt.offsets.dtype == jt.offsets.dtype
    np.testing.assert_array_equal(tt._seg_dev, jt._seg_dev)


def test_vocabulary_and_defaults_equal():
    assert ttr.STATE_NAMES == jtr.STATE_NAMES
    assert ttr.STATE_CODES == jtr.STATE_CODES
    assert ttr.DEFAULT_STATE_LOADS == jtr.DEFAULT_STATE_LOADS
    assert ttr.DEFAULT_ONLINE_STATES == jtr.DEFAULT_ONLINE_STATES


def test_data_file_is_a_byte_identical_copy():
    assert ttr.sample_trace_path() != jtr.sample_trace_path()
    assert filecmp.cmp(ttr.sample_trace_path(), jtr.sample_trace_path(),
                       shallow=False)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compile_events_equal(seed):
    ev = _events(seed)
    _assert_trace_equal(ttr.compile_events(ev, 2 * DAY),
                        jtr.compile_events(ev, 2 * DAY))


@pytest.mark.parametrize("bad", [
    ({}, DAY), ({"a": []}, DAY), ({"a": [(DAY, 1)]}, DAY),
    ({"a": [(0.0, 9)]}, DAY), ({"a": [(0.0, 1)]}, 0.0)])
def test_compile_events_refuses_like_the_reference(bad):
    with pytest.raises(ValueError):
        jtr.compile_events(*bad)
    with pytest.raises(ValueError):
        ttr.compile_events(*bad)


def test_csv_round_trip_equal(tmp_path):
    ev = _events(5, same_instant=False)
    tt = ttr.compile_events(ev, 2 * DAY + 0.5)
    p_port, p_ref = tmp_path / "port.csv", tmp_path / "ref.csv"
    ttr.write_trace_csv(tt, str(p_port))
    jtr.write_trace_csv(jtr.compile_events(ev, 2 * DAY + 0.5), str(p_ref))
    assert p_port.read_bytes() == p_ref.read_bytes()
    back = ttr.read_trace_csv(str(p_port))
    assert back.equals(tt)
    _assert_trace_equal(back, jtr.read_trace_csv(str(p_port)))


def test_shipped_fixture_parses_equal():
    _assert_trace_equal(ttr.read_trace_csv(ttr.sample_trace_path()),
                        jtr.read_trace_csv(jtr.sample_trace_path()))


def test_fmt_equal():
    for t in (0.0, 18720.0, 1234567.0, 0.1, 604799.999, 1e-9, 86400.5):
        assert ttr.trace._fmt(t) == jtr.trace._fmt(t)


@pytest.mark.parametrize("spec", [
    dict(n_devices=4, days=2, seed=0),
    dict(n_devices=32, days=7, seed=11),
    dict(n_devices=5, days=9, seed=3, offline_prob_per_day=0.9,
         sessions_per_day=6.0),
])
def test_synthesize_trace_equal(spec):
    tt = ttr.synthesize_trace(ttr.SyntheticTraceSpec(**spec))
    jt = jtr.synthesize_trace(jtr.SyntheticTraceSpec(**spec))
    _assert_trace_equal(tt, jt)
    assert ttr.SyntheticTraceSpec(**spec).period_s == jtr.SyntheticTraceSpec(**spec).period_s


@pytest.mark.parametrize("n,seed,jitter", [(1, 0, 1800.0), (37, 4, 1800.0),
                                           (500, 9, 0.0), (64, 2, 7200.0)])
def test_resample_equal(n, seed, jitter):
    tt = ttr.read_trace_csv(ttr.sample_trace_path())
    jt = jtr.read_trace_csv(jtr.sample_trace_path())
    tf = tt.resample(n, seed=seed, phase_jitter_s=jitter, device="cpu")
    jf = jt.resample(n, seed=seed, phase_jitter_s=jitter)
    np.testing.assert_array_equal(tf.src, jf.src)
    np.testing.assert_array_equal(tf.phase_s, jf.phase_s)
    assert tf.n == jf.n and tf.device.type == "cpu"


@pytest.mark.parametrize("lut", [(False, True, True, True),
                                 (False, False, False, True),
                                 (True, True, True, True),
                                 (False, True, False, True)])
def test_online_flip_tau_equal(lut):
    spec = dict(n_devices=8, days=3, seed=4)
    tt = ttr.synthesize_trace(ttr.SyntheticTraceSpec(**spec))
    jt = jtr.synthesize_trace(jtr.SyntheticTraceSpec(**spec))
    lut = np.array(lut)
    got = tt.online_flip_tau(lut)
    np.testing.assert_array_equal(got, jt.online_flip_tau(lut))
    assert tt.online_flip_tau(lut) is got                 # memoized per LUT


def _avail_pair(spec_kw, n, seed, **replay):
    tspec = ttr.TraceSpec(synthetic=ttr.SyntheticTraceSpec(**spec_kw), **replay)
    jspec = jtr.TraceSpec(synthetic=jtr.SyntheticTraceSpec(**spec_kw), **replay)
    return tspec.resolve(n, seed=seed, device="cpu"), jspec.resolve(n, seed=seed)


@pytest.mark.parametrize("replay", [
    {}, {"seconds_per_round": 1800.0}, {"seconds_per_round": 7000.0},
    {"online_states": ("charging",)}])
def test_next_transition_equal_reference_and_scan(replay):
    (tload, tav), (jload, jav) = _avail_pair(
        dict(n_devices=5, days=2, seed=7, offline_prob_per_day=0.8), 12, 3,
        **replay)
    assert tav.rounds_per_period() == jav.rounds_per_period()
    for r0 in range(0, 40, 3):
        np.testing.assert_array_equal(tav.mask(None, r0), jav.mask(None, r0))
        np.testing.assert_array_equal(tload.loads(None, r0), jload.loads(None, r0))
        got = tav.next_transition(None, r0)
        assert got == jav.next_transition(None, r0), r0
        scan = tav._next_transition_scan(None, r0)
        assert scan == jav._next_transition_scan(None, r0), r0
        if replay.get("seconds_per_round", 3600.0) != 7000.0:
            assert got == scan, r0            # aligned period: exact oracle


def test_next_transition_never_changes_equal():
    ev = {"a": [(0.0, jtr.STATE_CODES["idle"])]}
    for spr in (3600.0, 7000.0):
        tav = ttr.TraceAvailability(
            ttr.compile_events(ev, DAY).resample(8, seed=0, phase_jitter_s=0.0,
                                                 device="cpu"),
            seconds_per_round=spr)
        jav = jtr.TraceAvailability(
            jtr.compile_events(ev, DAY).resample(8, seed=0, phase_jitter_s=0.0),
            seconds_per_round=spr)
        assert tav.next_transition(None, 0) is None
        assert jav.next_transition(None, 0) is None
        assert tav._next_transition_scan(None, 0) == jav._next_transition_scan(None, 0)


def test_trace_models_draw_no_rng_and_share_one_fleet():
    load, avail = ttr.TraceSpec(csv=ttr.sample_trace_path()).resolve(
        20, seed=1, device="cpu")
    assert load.fleet is avail.fleet
    rng = np.random.default_rng(0)
    state = rng.bit_generator.state
    assert load.init_state(20, rng) is None and avail.init_state(20, rng) is None
    assert rng.bit_generator.state == state
    with pytest.raises(ValueError, match="resampled to 20"):
        load.init_state(21, rng)


def test_trace_spec_needs_one_source():
    with pytest.raises(ValueError):
        ttr.TraceSpec()
    with pytest.raises(ValueError):
        ttr.TraceSpec(csv="x.csv", synthetic=ttr.SyntheticTraceSpec())


@pytest.mark.parametrize("name", ["trace-livelab", "trace-synthetic-week"])
def test_trace_scenario_pools_equal(name):
    tpool = tfl.build_scenario(name, 30, seed=2, device="cpu")
    jpool = jfl.build_scenario(name, 30, seed=2)
    assert tpool.failures.dropout == jpool.failures.dropout
    for _ in range(4):
        np.testing.assert_array_equal(tpool.available(), jpool.available())
        np.testing.assert_array_equal(tpool.loads(), jpool.loads())
        nxt = tpool.next_transition()
        assert nxt == jpool.next_transition()
        tpool.advance_to(nxt)
        jpool.advance_to(nxt)
        assert tpool.round_idx == jpool.round_idx


@pytest.mark.parametrize("name", ["uniform", "high-churn", "nightly-chargers"])
def test_pool_advance_to_and_next_transition_equal(name):
    tpool = tfl.build_scenario(name, 16, seed=0)
    jpool = jfl.build_scenario(name, 16, seed=0)
    for target in (3, 4, 9):
        assert tpool.next_transition() == jpool.next_transition()
        tpool.advance_to(target)
        jpool.advance_to(target)
        assert tpool.round_idx == jpool.round_idx
        np.testing.assert_array_equal(tpool.available(), jpool.available())
        np.testing.assert_array_equal(tpool.loads(), jpool.loads())


def _fl_data():
    from repro.data import FederatedData, dirichlet_partition, make_classification_data

    train, test = make_classification_data(n_samples=2000, seed=0)
    return FederatedData(train, test, dirichlet_partition(train.y, 20, sigma=0.1, seed=0))


def _server_pair(data, **kw):
    cfg = dict(n_devices=20, k_select=3, rounds=3, l_ep=2, lr=0.1, seed=5)
    cfg.update(kw)
    jsrv = jfl.FLServer(jfl.FLConfig(**cfg), jfl.MLPTask(dim=32, hidden=32), data)
    tsrv = tfl.FLServer(tfl.FLConfig(**cfg), tfl.MLPTask(dim=32, hidden=32),
                        tdata.FederatedData(data.train, data.test, data.client_indices),
                        device="cpu")
    tsrv.global_params = params_from_numpy(
        {k: np.asarray(v) for k, v in jsrv.global_params.items()}, "cpu")
    tsrv._last_acc = jsrv._last_acc
    return jsrv, tsrv


@pytest.mark.parametrize("scenario", ["trace-livelab", "trace-synthetic-week"])
def test_sync_rounds_on_trace_scenarios_equal(scenario):
    jsrv, tsrv = _server_pair(_fl_data(), scenario=scenario)
    for _ in range(3):
        jr = jsrv.run_round(jfl.build_policy("fedavg"))
        tr = tsrv.run_round(tfl.build_policy("fedavg"))
        np.testing.assert_array_equal(tr.selected, jr.selected)
        np.testing.assert_array_equal(tr.failed, jr.failed)
        assert tr.n_available == jr.n_available
        assert (tr.r_t, tr.r_e, tr.cum_time) == (jr.r_t, jr.r_e, jr.cum_time)
        assert abs(tr.acc - jr.acc) <= 1e-5


def test_trace_csv_override_equal(tmp_path):
    path = tmp_path / "mine.csv"
    jtr.write_trace_csv(jtr.synthesize_trace(jtr.SyntheticTraceSpec(
        n_devices=6, days=2, seed=1)), str(path))
    for scenario in ("high-churn", "trace-synthetic-week"):
        jsrv, tsrv = _server_pair(_fl_data(), scenario=scenario,
                                  trace_csv=str(path))
        assert tsrv.pool.availability.fleet.trace.n_devices == 6
        assert (tsrv.pool.availability.seconds_per_round
                == jsrv.pool.availability.seconds_per_round)
        jr = jsrv.run_round(jfl.build_policy("fedavg"))
        tr = tsrv.run_round(tfl.build_policy("fedavg"))
        np.testing.assert_array_equal(tr.selected, jr.selected)
        assert tr.n_available == jr.n_available and tr.r_t == jr.r_t
