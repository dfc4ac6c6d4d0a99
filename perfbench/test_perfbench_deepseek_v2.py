"""The ``dsv2-lite-fl-fedrank`` cell on the CPU at the smoke size: the
program against the ``deepseek_v2`` family's reference in fp32, the fp8
control and a planted fault against the cell's limits, the FLOP counts by
hand, and the readers of the new spans and counters (``mla_ms``,
``moe_ms``, ``moe_slot_fill``)."""
import json
import math
from pathlib import Path

import pytest
import torch

from perfbench import bench, check, flops
from perfbench.calibrate import readings
from perfbench.smoke import smoke_spec

HERE = Path(__file__).resolve().parent
BENCHMARK = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELL = "dsv2-lite-fl-fedrank"
SEED = 2 ** 31 + 4242            # larger than 32 signed bits hold
NEW = ("mla_ms", "moe_ms", "moe_slot_fill")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_matches_port_in_fp32():
    """The port and the family's reference agree to fp32 rounding over the
    five checked rounds (the Q-net's change follows fp32 round-off through
    Adam's first steps, which divide by |g|)."""
    nums = readings(CELL, SEED, control=False, device="cpu", spec=smoke_spec(CELL))["program"]
    for name, value in nums.items():
        assert value <= (2e-3 if name == "qnet" else 1e-5), (name, value)


def test_control_fails_the_limits():
    wl, _, _ = bench.load_cell(CELL)
    got = readings(CELL, SEED, control=True, device="cpu", spec=smoke_spec(CELL, "bfloat16"))
    assert not check.verdict(got["control"], wl["limits"]), got["control"]


@pytest.mark.parametrize("fault", [None, "half_batch"])
def test_run_with_half_the_batch_left_out_is_not_correct(fault, monkeypatch):
    from repro_torch.fl import engine
    from repro_torch.fl.tasks import LMTask

    if fault:
        loss = LMTask.loss

        def half(self, p, batch):
            return loss(self, p, {k: (v[: v.shape[0] // 2] if torch.is_tensor(v) else v)
                                  for k, v in batch.items()})
        monkeypatch.setattr(LMTask, "loss", half)
    try:
        out = bench.run(CELL, SEED, 0.01, False, 0.0, device="cpu", spec=smoke_spec(CELL))
    finally:
        engine._bucket_step.cache_clear()
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["correct"] is (fault is None), out["checks"]
    assert all(math.isfinite(r["value"]) for r in out["checks"].values())


def test_flops_against_hand_counts():
    _, conf, _ = bench.load_cell(CELL)
    d = 2048
    # MLA: wq 2048 x 16*192, wkv_a 2048 x (512 + 64), wkv_b 512 x 16*256, wo 16*128 x 2048
    mla = d * 3072 + d * 576 + 512 * 4096 + 2048 * d
    assert mla == 13_762_560
    # layer 0 dense (3 x 2048 x 10944); 4 expert layers: router 2048 x 64,
    # 2 shared experts of 3 x 2048 x 1408, and 6 x 8 / 64 = 0.75 of a routed one
    expert = 3 * d * 1408
    per = 5 * mla + 3 * d * 10944 + 4 * (d * 64 + 2 * expert + 0.75 * expert) + d * 102400
    assert flops.matmul_params(conf) == per == 441_450_496
    # causal attention at S = 64: S(S+1)/2 pairs, q.k at 192 and p.v at 128,
    # 2 FLOPs a product, 16 heads, 5 layers
    att = 64 * 65 / 2 * 2 * (192 + 128) * 16 * 5
    assert flops.attention_flops(conf, 64) == att
    assert flops.round_flops(conf, 64, 160, 16) == (160 * (6 * per * 64 + 3 * att)
                                                    + 16 * (2 * per * 64 + att))


def _span(path, device=None):
    s = {"span": path, "t0_s": 0.0, "wall_s": 0.001}
    if device is not None:
        s["device_s"] = device
    return s


def _rec():
    counters = [{"moe.slots": 960, "moe.pairs_held": 800, "moe.pairs_kept": 720},
                {"moe.slots": 960, "moe.pairs_held": 790, "moe.pairs_kept": 768}]
    return {"rounds": [
        {"type": "round", "metrics": {"counters": counters[0]}, "spans": [
            _span("probe/grad/mla", 0.004), _span("probe/grad/moe", 0.010),
            _span("probe/grad/mla", 0.006), _span("probe/grad", 0.1),
            _span("evaluate/mla", 0.001), _span("evaluate/moe", 0.002)]},
        {"type": "round", "metrics": {"counters": counters[1]}, "spans": [
            _span("probe/grad/mla", 0.002), _span("probe/grad/moe", 0.020)]},
        {"type": "event"}]}


def test_readers_equal_hand_means_and_find_nothing_without_their_spans():
    read = {n: bench.load_metric(n) for n in NEW}
    rec = _rec()
    assert read["mla_ms"](rec) == pytest.approx(1e3 * ((0.004 + 0.006 + 0.001) + 0.002) / 2)
    assert read["moe_ms"](rec) == pytest.approx(1e3 * ((0.010 + 0.002) + 0.020) / 2)
    assert read["moe_slot_fill"](rec) == pytest.approx(100.0 * (720 + 768) / (960 + 960))
    bare = {"rounds": [{"type": "round", "spans": [_span("probe/grad", 0.1)],
                        "metrics": {"counters": {"sgd_update.launches": 24}}}]}
    for n in NEW:
        assert read[n](bare) is None and read[n]({}) is None
    # spans with no device clock (the CPU) read nothing
    wall = {"rounds": [{"type": "round", "spans": [_span("probe/grad/mla"), _span("x/moe")]}]}
    assert read["mla_ms"](wall) is None and read["moe_ms"](wall) is None


def test_benchmark_entries_of_the_cell_and_its_metrics():
    per_layer = {m["name"]: m for m in BENCHMARK["per_layer"]}
    assert per_layer["mla_ms"]["workloads"] == [CELL]
    for n in ("moe_ms", "moe_slot_fill"):
        assert per_layer[n]["workloads"] == ["olmoe-1b-7b-fl-fedrank", CELL]
    assert {per_layer[n]["moves"] for n in NEW} == {"round_s"}
    assert len({per_layer[n]["layer"] for n in NEW}) == 1
    cell = next(w for w in BENCHMARK["workloads"] if w["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "deepseek-v2-lite-fl", "fl-lm-fedrank-k4", 1)


def test_traced_cpu_run_reports_the_slot_fill():
    out = bench.run(CELL, SEED, 0.01, True, 0.0, device="cpu", spec=smoke_spec(CELL))
    assert out["correct"], out["checks"]
    # the CPU has no device events: the span readers find nothing there
    assert not {"mla_ms", "moe_ms"} & set(out["metrics"])
    assert 0 < out["metrics"]["moe_slot_fill"]["value"] <= 100
    assert {"executor_ms", "mfu", "merge_eval_ms"} <= set(out["metrics"])
    # the selection layer's metrics list the other FedRank cells only
    assert not {"selection_ms", "topk_roofline"} & set(out["metrics"])


@pytest.mark.parametrize("key,value", [("routed_scaling_factor", 2.5), ("norm_topk_prob", True),
                                       ("seq_aux", False), ("topk_method", "group_limited_greedy")])
def test_family_refuses_gates_its_reference_does_not_compute(key, value):
    raw = json.loads((HERE / "configs" / "deepseek-v2-lite-fl.json").read_text())
    fam = bench.model_dims(raw)["family"]
    assert fam.endswith("deepseek_v2.py")
    with pytest.raises(ValueError, match="deepseek_v2 family"):
        bench.model_dims(dict(raw, **{key: value}))
