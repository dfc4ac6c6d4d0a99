"""The port's observability layer (``repro_torch.obs``) against the reference.

* Observed runs in both packages on the same inputs (a synchronous FedRank
  run on ``high-churn``, an asynchronous run on ``trace-synthetic-week``,
  hierarchical sync and async runs on ``hierarchical``) write the same
  records: the same sequence of round records and events, the same span
  names in the same order, the same virtual clock on every span, the same
  metric names and values, the same op names (the reference's backend
  routes named as the port's) and call counts, and the same fields; only
  host wall times differ, and the model's accuracy agrees within 1e-5.
* The port's ``run.jsonl``, read with the reference's
  ``repro.obs.report.load_run``, passes the reference's ``check_run``
  unchanged.
  The port's own spans (``PORT_ONLY_SPANS``: the round's context, request
  building, the vmapped executor's inputs, gradient and SGD update, FedRank's
  featurising and TD steps) are taken out by name before the comparison and
  checked present on their own; so are its own counters
  (``PORT_ONLY_COUNTERS``: the vmapped executor's SGD-update launches and
  elements).
* ``observe=None`` is the shared ``NULL_RECORDER``, and an observed run
  gives exactly the cohorts and params of an unobserved one.
* The pieces: span nesting and both clocks, device times resolved at the
  flush from injected events, profiler ranges, ``profiling.span`` with and
  without an active recorder, the leaf spans of a vmapped FedRank round,
  the metrics window, the
  logger's threshold and ``REPRO_LOG_LEVEL`` fallback, ``make_recorder``,
  ``config_digest`` ignoring ``observe``, ``timed_call`` passing through with
  no profiler, ``trace_gate`` and the ``async-stall`` event.
"""
import io
import json
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fl as jfl
import repro.obs as jobs
import repro.obs.report as jreport
import repro_torch.data as tdata
import repro_torch.fl as tfl
import repro_torch.obs as tobs
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl.async_engine import AsyncRoundEngine
from repro_torch.obs.report import check_run, coverage, load_run, op_table, phase_table

TOL = 1e-5
# keys whose values vary between identical runs (host and device clocks)
VOLATILE_KEYS = {"wall_s", "t0_s", "device_s", "host_time_s", "host_s", "created_at"}
# leaf names of the spans that only the port records (the reference has no
# span at these boundaries)
PORT_ONLY_SPANS = {"context", "requests", "inputs", "grad", "sgd_update", "featurize",
                   "td_steps"}
# counters that only the port records (the vmapped executor's update op)
PORT_ONLY_COUNTERS = {"sgd_update.launches", "sgd_update.elements",
                      "sgd_update.kernel_elements"}
# float fields that carry the model's quality: equal within fp32 rounding
MODEL_KEYS = {"acc"}
# the reference's backend routes under the port's names (on the CPU the
# reference takes XLA or numpy, the port its plain versions)
OP_NAMES = {"select_topk.xla": "select_topk.plain",
            "select_topk.pallas": "select_topk.plain",
            "fleet_state.xla": "fleet_state.plain",
            "fleet_state.numpy": "fleet_state.plain",
            "fleet_state.pallas": "fleet_state.plain"}


@pytest.fixture(autouse=True)
def _no_profiler_leak():
    """Observed servers register a module-global profiler in each package;
    clear both after every test so later kernel calls stay passthroughs."""
    yield
    tobs.clear_profiler()
    jobs.clear_profiler()


def _cpu(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _tdata(fl_data):
    return tdata.FederatedData(fl_data.train, fl_data.test, fl_data.client_indices)


def _servers(fl_data, **kw):
    cfg = dict(n_devices=20, k_select=4, rounds=2, l_ep=2, lr=0.1, seed=3)
    cfg.update(kw)
    jrec, trec = jobs.RunRecorder(), tobs.RunRecorder()
    jsrv = jfl.FLServer(jfl.FLConfig(observe=jrec, **cfg),
                        jfl.MLPTask(dim=32, hidden=32), fl_data)
    tsrv = tfl.FLServer(tfl.FLConfig(observe=trec, **cfg),
                        tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data), device="cpu")
    tsrv.global_params = _cpu(jsrv.global_params)
    tsrv._last_acc = jsrv._last_acc
    return jsrv, tsrv, jrec, trec


def _feed(jsrv, tsrv, jpol=None, tpol=None):
    tsrv.global_params = _cpu(jsrv.global_params)
    tsrv.last_loss = jsrv.last_loss.copy()
    tsrv.loss_age = jsrv.loss_age.copy()
    tsrv._last_acc = jsrv._last_acc
    if jpol is not None:
        tpol.q, tpol.q_target = _cpu(jpol.q), _cpu(jpol.q_target)
        tpol._opt_m, tpol._opt_v = _cpu(jpol._opt_m), _cpu(jpol._opt_v)
        tpol._opt_t = int(jpol._opt_t)
        tpol.replay.items = list(jpol.replay.items)
        tpol._pending = jpol._pending


def _assert_same_value(ref, got, key):
    if isinstance(ref, dict):
        assert isinstance(got, dict), key
        if key.endswith(".ops"):
            ref = {OP_NAMES.get(k, k): v for k, v in ref.items()}
        assert sorted(got) == sorted(k for k in ref if k not in VOLATILE_KEYS), key
        for k in got:
            _assert_same_value(ref[k], got[k], f"{key}.{k}")
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), key
        for i, (r, g) in enumerate(zip(ref, got)):
            _assert_same_value(r, g, f"{key}[{i}]")
    elif key.split(".")[-1] in MODEL_KEYS:
        assert abs(float(got) - float(ref)) <= TOL, key
    else:
        assert got == ref, (key, ref, got)


def _scrub(value):
    if isinstance(value, dict):
        return {k: _scrub(v) for k, v in value.items() if k not in VOLATILE_KEYS}
    if isinstance(value, list):
        return [_scrub(v) for v in value]
    return value


def _leaf(path):
    return path.rsplit("/", 1)[-1]


def _assert_records_match(jrec, trec):
    """The records equal, the port-only spans taken out; returns the paths
    of the port-only spans that were taken out."""
    ref = _scrub(json.loads(json.dumps(jrec.records, default=float)))
    got = _scrub(json.loads(json.dumps(trec.records, default=float)))
    assert len(got) == len(ref) > 0
    port_only = set()
    for i, (r, g) in enumerate(zip(ref, got)):
        assert g.get("type") == r.get("type") and g.get("event") == r.get("event"), i
        if r.get("type") == "round":
            port_only |= {s["span"] for s in g["spans"] if _leaf(s["span"]) in PORT_ONLY_SPANS}
            g["spans"] = [s for s in g["spans"] if _leaf(s["span"]) not in PORT_ONLY_SPANS]
            for name in PORT_ONLY_COUNTERS:
                g["metrics"]["counters"].pop(name, None)
            assert [s["span"] for s in g["spans"]] == [s["span"] for s in r["spans"]], i
        _assert_same_value(r, g, f"record[{i}]")
    return port_only


def test_observed_sync_fedrank_records_equal_reference(fl_data):
    jsrv, tsrv, jrec, trec = _servers(fl_data, scenario="high-churn")
    jpol = jcore.FedRankPolicy(None, k=4, seed=0, train_batch=4,
                               train_steps_per_round=1)
    tpol = tfl.build_policy("fedrank", qnet=_cpu(jpol.q), k=4, seed=0,
                            train_batch=4, train_steps_per_round=1)
    for _ in range(2):
        _feed(jsrv, tsrv, jpol, tpol)
        jr, tr = jsrv.run_round(jpol), tsrv.run_round(tpol)
        np.testing.assert_array_equal(tr.selected, jr.selected)
    port_only = _assert_records_match(jrec, trec)
    assert port_only == {"context", "plan/featurize", "probe/requests", "complete/requests"}
    rounds = [r for r in trec.records if r["type"] == "round"]
    assert [s["span"] for s in rounds[0]["spans"] if "/" not in s["span"]] == [
        "context", "plan", "probe", "select", "complete", "aggregate", "telemetry",
        "evaluate", "observe"]
    assert rounds[0]["ops"]["select_topk.plain"]["n"] == 2
    assert rounds[0]["ops"]["executor.sequential"]["n"] == 2


@pytest.mark.parametrize("executor", ["sequential", "vmapped"])
def test_observed_async_trace_records_equal_reference(fl_data, executor):
    jsrv, tsrv, jrec, trec = _servers(
        fl_data, scenario="trace-synthetic-week", mode="async", rounds=3,
        async_concurrency=8, staleness="polynomial", executor=executor)
    jsrv.run(jcore.RandomPolicy())
    tsrv.run(tfl.build_policy("fedavg"))
    port_only = _assert_records_match(jrec, trec)
    # the async engine builds its own requests; the vmapped executor's
    # spans nest under the stage that dispatched the wave
    assert {_leaf(p) for p in port_only} == (
        {"inputs", "grad", "sgd_update"} if executor == "vmapped" else set())
    rounds = [r for r in trec.records if r["type"] == "round"]
    spans = {s["span"] for r in rounds for s in r["spans"]}
    assert {"ready_check", "aggregate", "dispatch", "events",
            "aggregate/evaluate"} <= spans
    assert all("v0_s" in s and "v1_s" in s for r in rounds for s in r["spans"]
               if "/" not in s["span"])
    assert sum(r["ops"].get("fleet_state.plain", {"n": 0})["n"] for r in rounds) > 0
    assert all({"staleness", "events_per_window"} <= set(r["metrics"]["histograms"])
               or r is rounds[0] for r in rounds)
    if executor == "vmapped":
        assert any(k.startswith("vmapped.bucket_step[") for r in rounds for k in r["ops"])
    # the update's counters: every element on the plain version on the CPU
    counters = [r["metrics"]["counters"] for r in rounds]
    elements = sum(c.get("sgd_update.elements", 0) for c in counters)
    assert (elements > 0) == (executor == "vmapped")
    assert sum(c.get("sgd_update.launches", 0) + c.get("sgd_update.kernel_elements", 0)
               for c in counters) == 0


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_observed_hierarchical_records_equal_reference(fl_data, mode):
    jsrv, tsrv, jrec, trec = _servers(fl_data, scenario="hierarchical", mode=mode,
                                      k_select=6, async_concurrency=12)
    jsrv.run(jcore.RandomPolicy())
    tsrv.run(tfl.build_policy("fedavg"))
    # the hierarchy's rounds run neither the server's nor FedRank's spans
    assert _assert_records_match(jrec, trec) == set()
    gauges = {k for r in trec.records if r["type"] == "round"
              for k in r["metrics"]["gauges"]}
    assert any(k.startswith("tier_lag.") for k in gauges)
    if mode == "async":
        assert "root_buffer_fill" in gauges
        assert any(k.startswith("region_buffer_fill.") for k in gauges)
    else:
        assert "n_regions" in gauges


@pytest.mark.parametrize("scenario,mode", [("high-churn", "sync"),
                                           ("trace-synthetic-week", "async")])
def test_port_jsonl_passes_the_reference_check(fl_data, tmp_path, scenario, mode):
    out = tmp_path / "run"
    cfg = tfl.FLConfig(n_devices=20, k_select=4, rounds=3, l_ep=2, lr=0.1, seed=3,
                       scenario=scenario, mode=mode, async_concurrency=8,
                       observe=str(out))
    srv = tfl.FLServer(cfg, tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data), device="cpu")
    srv.run(tfl.build_policy("fedrank", k=4, seed=0, device="cpu"))
    srv.obs.close()
    manifest, rounds, events = jreport.load_run(str(out))
    assert jreport.check_run(rounds) == []
    assert len(rounds) == 3
    assert manifest["config_digest"] == tobs.config_digest(cfg)
    assert manifest["versions"]["torch"] == torch.__version__
    assert manifest["platform"]["backend"] == "cpu"
    # the port's own reduction reads the same
    m2, r2, e2 = load_run(str(out))
    assert (m2, r2, e2) == (manifest, rounds, events)
    assert check_run(r2) == [] and coverage(r2) == jreport.coverage(rounds)
    assert phase_table(r2) == jreport.phase_table(rounds)
    assert op_table(r2) == jreport.op_table(rounds)
    assert "select_topk.plain" in {row["op"] for row in op_table(r2)}
    assert jreport.render(manifest, rounds, events).startswith("run: scenario=")


@pytest.mark.parametrize("kw", [dict(scenario="high-churn", policy="fedrank"),
                                dict(scenario="high-churn", policy="fedrank",
                                     executor="vmapped"),
                                dict(scenario="trace-synthetic-week", mode="async",
                                     async_concurrency=8, policy="fedavg"),
                                dict(scenario="hierarchical", policy="fedrank",
                                     k_select=6)])
def test_observing_changes_no_result(fl_data, kw):
    kw = dict(kw)
    policy, k = kw.pop("policy"), kw.pop("k_select", 4)
    runs = []
    for observe in (None, True):
        cfg = tfl.FLConfig(n_devices=20, k_select=k, rounds=2, l_ep=2, lr=0.1, seed=3,
                           observe=observe, **kw)
        srv = tfl.FLServer(cfg, tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data),
                           device="cpu")
        pkw = dict(k=k, seed=0, device="cpu") if policy == "fedrank" else {}
        hist = srv.run(tfl.build_policy(policy, **pkw))
        runs.append((hist, srv))
        tobs.clear_profiler()
    (h0, s0), (h1, s1) = runs
    assert s0.obs is tobs.NULL_RECORDER and s0.obs.records == []
    assert s1.obs.enabled and len(s1.obs.records) >= len(h1)
    for a, b in zip(h0, h1):
        np.testing.assert_array_equal(a.selected, b.selected)
        assert (a.acc, a.cum_time, a.r_e) == (b.acc, b.cum_time, b.r_e)
    p0, p1 = params_to_numpy(s0.global_params), params_to_numpy(s1.global_params)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k])


def test_span_nesting_and_dual_clocks():
    rec = tobs.RunRecorder()
    clock = iter([10.0, 12.5, 20.0, 30.0])
    with rec.span("aggregate", clock=lambda: next(clock)):
        with rec.span("evaluate", clock=lambda: next(clock)):
            pass
    rec.flush_round(round=0, mode="async", host_time_s=1.0)
    spans = rec.records[0]["spans"]
    assert [s["span"] for s in spans] == ["aggregate/evaluate", "aggregate"]
    assert (spans[0]["v0_s"], spans[0]["v1_s"]) == (12.5, 20.0)
    assert (spans[1]["v0_s"], spans[1]["v1_s"]) == (10.0, 30.0)
    assert all(s["wall_s"] >= 0 for s in spans)
    assert tobs.NULL_RECORDER.span("x") is tobs.NULL_RECORDER.span("y")


class _StubEvent:
    """A device event on a made-up clock (seconds), for the CPU."""

    def __init__(self, t, synced):
        self.t, self.synced = t, synced

    def synchronize(self):
        self.synced.append(self.t)

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def test_device_times_resolved_at_flush_from_injected_events():
    ticks, synced = iter([1.0, 1.5, 3.0, 7.25]), []
    rec = tobs.RunRecorder(device_event=lambda: _StubEvent(next(ticks), synced))
    with rec.span("aggregate"):
        with rec.span("evaluate"):
            pass
    inner, outer = rec._spans
    assert "device_s" not in inner and "device_s" not in outer and synced == []
    rec.flush_round(round=0, mode="sync", host_time_s=1.0)
    # one wait, on the last exit event; each span its own pair
    assert synced == [7.25]
    assert inner["device_s"] == pytest.approx(1.5) and outer["device_s"] == pytest.approx(6.25)
    rec.flush_round(round=1, mode="sync", host_time_s=1.0)
    assert synced == [7.25] and rec.records[1]["spans"] == []


def test_spans_carry_ordered_host_starts_and_no_device_time_on_the_cpu():
    rec = tobs.RunRecorder()
    with rec.span("probe"):
        with rec.span("inputs"):
            pass
        with rec.span("grad"):
            pass
    rec.flush_round(round=0, mode="sync", host_time_s=1.0)
    inputs, grad, probe = rec.records[0]["spans"]
    assert [inputs["span"], grad["span"], probe["span"]] == ["probe/inputs", "probe/grad", "probe"]
    assert probe["t0_s"] <= inputs["t0_s"] <= inputs["t0_s"] + inputs["wall_s"] <= grad["t0_s"]
    assert grad["t0_s"] + grad["wall_s"] <= probe["t0_s"] + probe["wall_s"]
    assert not any("device_s" in s for s in (inputs, grad, probe))


def test_profiling_span_routes_to_the_active_recorder():
    from repro_torch.obs import profiling

    tobs.clear_profiler()
    assert profiling.span("grad") is tobs.NULL_RECORDER.span("x")
    rec = tobs.RunRecorder()
    tobs.set_profiler(rec)
    with rec.span("probe"):
        with profiling.span("grad"):
            pass
    tobs.clear_profiler(rec)
    assert [s["span"] for s in rec._spans] == ["probe/grad", "probe"]


def test_span_opens_a_profiler_range_only_while_the_profiler_runs():
    from torch.profiler import ProfilerActivity, profile

    rec = tobs.RunRecorder()
    with rec.span("outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("probe"):
            with rec.span("sgd_update"):
                torch.ones(8).sum()
    ranges = [e.name() for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()]
    assert "probe" in ranges and "sgd_update" in ranges and "outside" not in ranges
    assert [s["span"] for s in rec._spans] == ["outside", "probe/sgd_update", "probe"]


def test_observed_vmapped_fedrank_round_lists_the_leaf_spans(fl_data):
    rec = tobs.RunRecorder()
    srv = tfl.FLServer(tfl.FLConfig(n_devices=20, k_select=4, rounds=3, l_ep=2, lr=0.1,
                                    seed=3, scenario="high-churn", executor="vmapped",
                                    observe=rec),
                       tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data), device="cpu")
    pol = tfl.build_policy("fedrank", k=4, seed=0, train_batch=4, train_steps_per_round=1,
                           device="cpu")
    srv.run(pol)
    rounds = [r for r in rec.records if r["type"] == "round"]
    # the third round is the first whose replay holds enough to train
    assert pol.metrics["loss"] and len(pol.metrics["loss"]) == 1
    spans = [s["span"] for s in rounds[2]["spans"]]
    want = ["context", "plan/featurize", "probe/requests", "probe/inputs", "probe/grad",
            "probe/sgd_update", "complete/requests", "complete/inputs", "complete/grad",
            "complete/sgd_update", "observe/td_steps"]
    assert [p for p in spans if _leaf(p) in PORT_ONLY_SPANS] == [
        p for p in spans if p in set(want)]
    assert set(want) <= set(spans)
    got = iter(spans)
    assert all(w in got for w in want), spans         # in this order
    assert "observe/td_steps" not in [s["span"] for s in rounds[0]["spans"]]


def test_metrics_snapshot_and_reset():
    m = tobs.MetricsRegistry()
    m.count("failures")
    m.count("failures", 2)
    m.gauge("fill", 5)
    m.gauge("fill", 7)
    m.observe("staleness", [1.0, 3.0])
    m.observe("staleness", 5.0)
    m.observe("empty", [])
    assert m.snapshot() == {
        "counters": {"failures": 3}, "gauges": {"fill": 7.0},
        "histograms": {"staleness": {"n": 3, "mean": 3.0, "min": 1.0, "max": 5.0}}}
    assert m.snapshot() == tobs.NULL_METRICS.snapshot()


def test_logger_level_threshold_and_force():
    out = io.StringIO()
    log = tobs.StructuredLogger(level="warning", stream=out)
    log.info("quiet", x=1)
    assert out.getvalue() == ""
    log.warning("loud", x=2)
    assert out.getvalue() == "[repro_torch.fl] loud x=2\n"
    log.log("forced", force=True, acc=0.51234)
    assert "forced acc=0.5123" in out.getvalue()
    with pytest.raises(ValueError):
        tobs.StructuredLogger(level="verbose")


def test_logger_env_fallback_and_recorder_feed(monkeypatch):
    monkeypatch.setenv("REPRO_LOG_LEVEL", "debug")
    out = io.StringIO()
    rec = tobs.RunRecorder()
    log = tobs.StructuredLogger(stream=out, recorder=rec)
    log.debug("dbg", k=1)
    assert "dbg k=1" in out.getvalue()
    assert rec.records == [{"type": "event", "event": "dbg", "level": "debug", "k": 1}]
    monkeypatch.setenv("REPRO_LOG_LEVEL", "error")
    quiet = io.StringIO()
    tobs.StructuredLogger(stream=quiet, recorder=tobs.NULL_RECORDER).warning("dropped")
    assert quiet.getvalue() == "" and tobs.NULL_RECORDER.records == []
    # FLConfig.log_level wins over the environment
    srv_log = tobs.StructuredLogger(level="info", stream=quiet)
    srv_log.info("kept")
    assert "kept" in quiet.getvalue()


def test_config_digest_ignores_observe(tmp_path):
    a = tfl.FLConfig(n_devices=10, seed=1, scenario="high-churn")
    b = tfl.FLConfig(n_devices=10, seed=1, scenario="high-churn", observe=str(tmp_path))
    c = tfl.FLConfig(n_devices=11, seed=1, scenario="high-churn")
    assert tobs.config_digest(a) == tobs.config_digest(b)
    assert tobs.config_digest(a) != tobs.config_digest(c)
    man = tobs.run_manifest(a)
    assert man["config_digest"] == tobs.config_digest(a)
    assert man["config"]["n_devices"] == 10 and "observe" not in man["config"]
    assert set(man["versions"]) == {"torch", "cuda", "numpy"}


def test_make_recorder_dispatch(tmp_path):
    assert tobs.make_recorder(None) is tobs.NULL_RECORDER
    assert tobs.make_recorder(False) is tobs.NULL_RECORDER
    mem = tobs.make_recorder(True, cfg=tfl.FLConfig(n_devices=4))
    assert mem.enabled and mem.out_dir is None and mem.manifest["seed"] == 0
    disk = tobs.make_recorder(str(tmp_path / "d"), cfg=tfl.FLConfig(n_devices=4))
    assert os.path.exists(tmp_path / "d" / "manifest.json")
    disk.close()
    pre = tobs.RunRecorder()
    assert tobs.make_recorder(pre) is pre
    with pytest.raises(ValueError):
        tobs.make_recorder(42)


def test_timed_call_passthrough_and_active():
    tobs.clear_profiler()
    assert tobs.timed_call("op", lambda a, b: a + b, 2, b=3) == 5
    rec = tobs.RunRecorder()
    tobs.set_profiler(rec)
    assert tobs.timed_call("op", lambda: {"w": torch.ones(2)})["w"].sum() == 2
    assert tobs.timed_call("op", lambda: 9) == 9
    rec.flush_round(round=0, mode="sync", host_time_s=0.0)
    assert rec.records[0]["ops"]["op"]["n"] == 2
    other = tobs.RunRecorder()
    tobs.set_profiler(other)
    tobs.clear_profiler(rec)
    assert tobs.active_profiler() is other
    tobs.clear_profiler(other)
    assert tobs.active_profiler() is None


def test_trace_gate_writes_a_chrome_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TRACE", raising=False)
    with tobs.trace_gate() as path:
        assert path is None
    with tobs.trace_gate(str(tmp_path)) as path:
        torch.ones(8).sum()
    assert os.path.getsize(path) > 0
    assert "traceEvents" in json.load(open(path))
    monkeypatch.setenv("REPRO_TORCH_TRACE", str(tmp_path / "env"))
    with tobs.trace_gate() as path:
        torch.ones(8).sum()
    assert os.path.dirname(path) == str(tmp_path / "env") and os.path.isfile(path)


def test_async_stall_emits_structured_event(fl_data, monkeypatch):
    rec = tobs.RunRecorder()
    srv = tfl.FLServer(tfl.FLConfig(n_devices=8, k_select=2, rounds=2, l_ep=1,
                                    seed=3, scenario="high-churn", mode="async",
                                    async_concurrency=4, observe=rec),
                       tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data), device="cpu")
    monkeypatch.setattr(AsyncRoundEngine, "_ready", lambda self: False)
    monkeypatch.setattr(AsyncRoundEngine, "_dispatch", lambda self: False)
    monkeypatch.setattr(AsyncRoundEngine, "_step", lambda self: False)
    with pytest.raises(tfl.AsyncStallError) as exc:
        srv.run(tfl.build_policy("fedavg"))
    assert exc.value.fields["aggregations_done"] == 0
    stalls = [r for r in rec.records if r.get("event") == "async-stall"]
    assert len(stalls) == 1 and stalls[0]["level"] == "error"
    assert stalls[0]["aggregations_target"] == 2 and stalls[0]["jobs_in_flight"] == 0


def test_observed_server_registers_profiler(fl_data):
    rec = tobs.RunRecorder()
    srv = tfl.FLServer(tfl.FLConfig(n_devices=8, k_select=2, rounds=1, l_ep=1, seed=3,
                                    scenario="high-churn", observe=rec, log_level="error"),
                       tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data), device="cpu")
    assert tobs.active_profiler() is rec and srv.log.level == 40
    hist = srv.run(tfl.build_policy("fedavg"))
    rounds = [r for r in rec.records if r.get("type") == "round"]
    assert f"executor.{hist[0].executor}" in rounds[0]["ops"]
    assert rounds[0]["executor"] == hist[0].executor
