"""The readers of the program's leaf spans (``client_grad_ms``,
``sgd_update_ms``, ``merge_ms``, ``host_prep_ms``): found by name, read from
a traced run at the smoke size on the CPU (where no span carries device
time), and equal to hand-computed means on a made-up record."""
import json
from pathlib import Path

import pytest
import torch

from perfbench import bench
from perfbench.smoke import smoke_spec

HERE = Path(__file__).resolve().parent
BENCHMARK = json.loads((HERE.parent / "BENCHMARK.json").read_text())
NEW = ("client_grad_ms", "sgd_update_ms", "merge_ms", "host_prep_ms")
DEVICE = ("client_grad_ms", "sgd_update_ms", "merge_ms")


def test_the_span_metrics_are_found_by_name():
    per_layer = {m["name"]: m for m in BENCHMARK["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert (m["source"], m["moves"], m["unit"]) == ("program_span", "round_s", "ms")
        assert "workloads" not in m and callable(bench.load_metric(name))


@pytest.mark.parametrize("cell", ["yi6b-fl-fedrank", "yi6b-fl-fedavg"])
def test_traced_cpu_run_reads_host_prep_and_no_device_time(cell):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = bench.run(cell, 2 ** 31 + 77, 0.01, True, 0.0, device="cpu",
                        spec=smoke_spec(cell))
    finally:
        torch.set_num_threads(n)
    assert out["correct"]
    assert out["metrics"]["host_prep_ms"]["value"] > 0
    assert not set(DEVICE) & set(out["metrics"])


def _span(path, wall, device=None):
    s = {"span": path, "t0_s": 0.0, "wall_s": wall}
    if device is not None:
        s["device_s"] = device
    return s


def _rec():
    return {"rounds": [
        {"type": "round", "spans": [
            _span("context", 0.002, 0.0001),
            _span("plan/featurize", 0.004, 0.0002),
            _span("probe/requests", 0.001, 0.0),
            _span("probe/inputs", 0.003, 0.0005),
            _span("probe/grad", 0.010, 0.100), _span("probe/sgd_update", 0.001, 0.060),
            _span("probe/grad", 0.010, 0.110), _span("probe/sgd_update", 0.001, 0.070),
            _span("probe", 0.3, 0.35),
            _span("complete/requests", 0.001, 0.0),
            _span("complete/inputs", 0.002, 0.001),
            _span("complete/grad", 0.010, 0.040), _span("complete/sgd_update", 0.001, 0.030),
            _span("complete", 0.1, 0.08),
            _span("aggregate", 0.002, 0.025),
            _span("async/aggregate", 0.5, 9.0),           # not top level: not the merge
            _span("evaluate", 0.03, 0.01)]},
        {"type": "event", "event": "note"},                   # not a round
        {"type": "round", "spans": [
            _span("context", 0.004, 0.0002),
            _span("probe/grad", 0.012, 0.120), _span("probe/sgd_update", 0.001, 0.050),
            _span("aggregate", 0.003, 0.035)]}]}


@pytest.mark.parametrize("name,want", [
    ("client_grad_ms", 1e3 * ((0.100 + 0.110 + 0.040) + 0.120) / 2),
    ("sgd_update_ms", 1e3 * ((0.060 + 0.070 + 0.030) + 0.050) / 2),
    ("merge_ms", 1e3 * (0.025 + 0.035) / 2),
    ("host_prep_ms", 1e3 * ((0.002 + 0.001 + 0.003 + 0.001 + 0.002) + 0.004) / 2)])
def test_readers_give_the_hand_computed_means(name, want):
    assert bench.load_metric(name)(_rec()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_readers_find_nothing_in_a_record_without_their_spans(name):
    """The parent's record: top-level spans with no device time."""
    rec = {"rounds": [{"type": "round", "spans": [_span("probe", 0.3), _span("aggregate", 0.002)]}]}
    assert bench.load_metric(name)(rec) is None
    assert bench.load_metric(name)({"rounds": []}) is None
