"""The harness's data-driven layout, its counts and its import rules."""
import ast
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import bench, flops
from perfbench.smoke import smoke_spec
from perfbench.traffic import generator

HERE = Path(__file__).resolve().parent
BENCHMARK = json.loads((HERE.parent / "BENCHMARK.json").read_text())


def test_every_cell_and_metric_is_found_by_name():
    for wl in BENCHMARK["workloads"]:
        got, conf, mix = bench.load_cell(wl["name"])
        assert got["config"] == wl["config"] and got["traffic"] == wl["traffic"]
        assert conf["name"] == wl["config"] and mix["n_devices"] > 0
    for m in BENCHMARK["per_layer"]:
        assert callable(bench.load_metric(m["name"]))
    for c in BENCHMARK["configs"]:
        raw = json.loads((HERE.parent / c["file"]).read_text())
        assert raw["name"] == c["name"] and set(raw["reduced"]) == set(c["reduced"])


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a mix, a cell and a per-layer metric added as files."""
    for d in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(HERE / d, tmp_path / d)
    raw = json.loads((HERE / "configs" / "yi-6b-fl.json").read_text())
    (tmp_path / "configs" / "yi-6b-fl-4l.json").write_text(
        json.dumps(dict(raw, name="yi-6b-fl-4l", num_hidden_layers=4)))
    mix = generator.load_mix("fl-lm-fedrank-k4")
    (tmp_path / "traffic" / "fl-lm-fedrank-k2.json").write_text(json.dumps(dict(mix, k=2)))
    (tmp_path / "workloads" / "yi6b-4l-fl-fedrank-k2.json").write_text(json.dumps(
        {"config": "yi-6b-fl-4l", "traffic": "fl-lm-fedrank-k2", "chips": 1, "why": "-"}))
    (tmp_path / "metrics" / "rounds_seen.py").write_text(
        "def read(rec):\n    return float(len(rec['rounds'])) or None\n")
    wl, conf, got = bench.load_cell("yi6b-4l-fl-fedrank-k2", root=tmp_path)
    assert conf["n_layers"] == 4 and got["k"] == 2 and wl["chips"] == 1
    assert bench.load_metric("rounds_seen", root=tmp_path)({"rounds": [{}, {}]}) == 2.0


def test_flops_against_hand_counts():
    _, yi, _ = bench.load_cell("yi6b-fl-fedrank")
    _, olmoe, _ = bench.load_cell("olmoe-1b-7b-fl-fedrank")
    # Yi-6B, 2 layers: q and o 4096 x 4096, k and v 4096 x 512, three FFN
    # matrices 4096 x 11008; head 4096 x 64000
    per = 2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008
    assert flops.matmul_params(yi) == 2 * per + 4096 * 64000 == 608_174_080
    # OLMoE, 1 layer: four 2048 x 2048, router 2048 x 64, 8 of 64 experts of
    # three 2048 x 1024; head 2048 x 50304
    per = 4 * 2048 * 2048 + 2048 * 64 + 8 * 3 * 2048 * 1024
    assert flops.matmul_params(olmoe) == per + 2048 * 50304 == 170_262_528
    # causal attention, forward: sum over queries of (i + 1) keys, 2 x Dh
    # for scores and again for values, per head and layer
    att = sum(2 * 2 * 128 * (i + 1) for i in range(64)) * 32 * 2
    assert flops.attention_flops(yi, 64) == att
    got = flops.round_flops(yi, 64, 160, 16)
    assert got == 160 * (6 * 608_174_080 * 64 + 3 * att) + 16 * (2 * 608_174_080 * 64 + att)
    assert abs(got / 1e12 - 38.65) < 0.01                 # 10,240 trained, 1,024 evaluated tokens
    # select_topk at the fleet's cut: 2N(FH + H^2 + H) fp32 FLOPs bound it
    assert flops.topk_bound_ms(1000, 6, 64, 8) == pytest.approx(
        1e3 * 2 * 1000 * (6 * 64 + 64 * 64 + 64) / 67e12)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    banned = {"jax", "jaxlib", "flax", "repro"}
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in banned, (f, name)
    for f in sorted((HERE / "reference").rglob("*.py")):     # nor anything of the port
        for name in _imports(f):
            assert name.split(".")[0] != "repro_torch", (f, name)


def test_forbidden_modules_compares_whole_top_level_names():
    assert bench.forbidden_modules({"repro_torch": 1, "repro_torch.fl": 1, "numpy": 1}) == []
    assert bench.forbidden_modules({"repro.fl.server": 1, "jax._src": 1}) == ["jax", "repro"]


def test_same_seed_same_traffic_other_seed_same_sizes():
    mix = generator.load_mix("fl-lm-fedrank-k4")
    mix = dict(mix, n_devices=30)
    a = generator.make_federation(mix, 1000, 2 ** 33 + 5, "cpu")
    b = generator.make_federation(mix, 1000, 2 ** 33 + 5, "cpu")
    c = generator.make_federation(mix, 1000, 7, "cpu")
    assert torch.equal(a.train_x, b.train_x) and torch.equal(a.test_y, b.test_y)
    assert a.train_x.shape == c.train_x.shape and not torch.equal(a.train_x, c.train_x)
    assert torch.equal(a.train_x[:, 1:], a.train_y[:, :-1])
    skew = dict(mix, seqs_per_device={"median": 16, "sigma": 1.0, "min": 4, "max": 64})
    s1, s2 = generator.device_sizes(skew, 1), generator.device_sizes(skew, 2)
    assert sorted(s1) == sorted(s2) and s1.min() >= 4 and s1.max() <= 64


def test_traced_run_reports_the_per_layer_metrics():
    torch.set_num_threads(1)
    cell = "yi6b-fl-fedrank"
    out = bench.run(cell, 5, 0.01, True, 0.0, device="cpu", spec=smoke_spec(cell))
    names = {m["name"] for m in BENCHMARK["per_layer"]}
    assert set(out["metrics"]) <= names
    # the CPU has no device events: the device readers find nothing
    assert {"executor_ms", "selection_ms", "merge_eval_ms", "mfu"} <= set(out["metrics"])
    assert out["correct"] and list(out)[-1] == "checks"


def test_benchmark_json_keeps_the_contract():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    assert set(BENCHMARK) == {"command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"}
    for m in BENCHMARK["end_to_end"]:
        assert name.match(m["name"]) and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert name.match(m["name"]) and m["moves"] in e2e
    for w in BENCHMARK["workloads"]:
        assert name.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "workloads" / f"{w['name']}.json").exists()
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    assert 1 <= BENCHMARK["run_seconds"] <= 51
