"""The harness's data-driven layout, its counts and its import rules."""
import ast
import dataclasses
import json
import math
import re
import shutil
from pathlib import Path

import pytest
import torch

from perfbench import bench, families, flops
from perfbench.reference import model as ref_model
from perfbench.smoke import smoke_spec
from perfbench.traffic import generator
from perfbench.weights import model_weights

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


# A family the decoder cannot express: one dense layer, then expert layers
# whose experts take ``moe_intermediate_size`` (not ``intermediate_size``),
# with unrenormalised top-k softmax gates and no drop.  It shares the
# decoder's attention by loading its sibling file.
TEST_FAMILY = '''"""One dense layer, then expert layers of ``moe_intermediate_size``."""
import dataclasses
from pathlib import Path

import torch

from perfbench import families
from perfbench.reference.model import _ffn, _mm, _rmsnorm
from perfbench.weights import DTYPES, _dense, _normal

_dec = families.load("decoder", Path(__file__).resolve().parents[1])


def dims(raw):
    conf = _dec.dims(raw)
    conf.update(first_dense=raw["first_k_dense_replace"],
                moe={"n_experts": raw["n_routed_experts"], "top_k": raw["num_experts_per_tok"],
                     "d_ff_expert": raw["moe_intermediate_size"]})
    return conf


def port_fields(conf, base):
    fields = _dec.port_fields({k: v for k, v in conf.items() if k != "moe"}, base)
    fields["moe"] = dataclasses.replace(base.moe, **conf["moe"])
    return fields


def weights(conf, gen, device):
    dt = DTYPES[conf["dtype"]]
    d, v, k = conf["d_model"], conf["vocab_size"], conf["first_dense"]
    qd, kvd = conf["n_heads"] * conf["head_dim"], conf["n_kv_heads"] * conf["head_dim"]
    e, fe, f = conf["moe"]["n_experts"], conf["moe"]["d_ff_expert"], conf["d_ff"]

    def stack(n, ffn):
        return {"norm1": {"scale": torch.ones(n, d, device=device)},
                "norm2": {"scale": torch.ones(n, d, device=device)},
                "attn": {"wq": _dense(gen, (n, d, qd), d, dt), "wk": _dense(gen, (n, d, kvd), d, dt),
                         "wv": _dense(gen, (n, d, kvd), d, dt), "wo": _dense(gen, (n, qd, d), qd, dt)},
                **ffn(n)}
    dense = stack(k, lambda n: {"mlp": {"up": _dense(gen, (n, d, f), d, dt),
                                        "gate": _dense(gen, (n, d, f), d, dt),
                                        "down": _dense(gen, (n, f, d), f, dt)}})
    experts = stack(conf["n_layers"] - k, lambda n: {"moe": {
        "router": _dense(gen, (n, d, e), d, torch.float32),
        "up": _dense(gen, (n, e, d, fe), d, dt), "gate": _dense(gen, (n, e, d, fe), d, dt),
        "down": _dense(gen, (n, e, fe, d), fe, dt)}})
    return {"embed": _normal(gen, (v, d), 0.02, dt), "dense": dense, "experts": experts,
            "final_norm": {"scale": torch.ones(d, device=device)},
            "lm_head": _normal(gen, (d, v), 0.02, dt)}


def _experts(conf, mp, h, prec):
    xt = h.reshape(-1, h.shape[-1])
    gates, idx = torch.softmax(xt @ mp["router"].float(), -1).topk(conf["moe"]["top_k"], -1)
    y = torch.zeros_like(xt)
    for ex in range(conf["moe"]["n_experts"]):
        tok, slot = torch.nonzero(idx == ex, as_tuple=True)
        out = _ffn(prec, xt[tok], mp["up"][ex], mp["gate"][ex], mp["down"][ex])
        y = y.index_add(0, tok, out * gates[tok, slot, None])
    return y.reshape(h.shape)


def forward(p, conf, tokens, prec):
    x = p["embed"].float()[tokens.long()]
    eps = conf["norm_eps"]
    for group in ("dense", "experts"):
        lay = p[group]
        for i in range(lay["norm1"]["scale"].shape[0]):
            lp = {g: {n: w[i] for n, w in lay[g].items()} for g in lay}
            x = x + _dec._attention(conf, lp["attn"], _rmsnorm(x, lp["norm1"]["scale"], eps), prec)
            h = _rmsnorm(x, lp["norm2"]["scale"], eps)
            x = x + (_ffn(prec, h, **lp["mlp"]) if group == "dense"
                     else _experts(conf, lp["moe"], h, prec))
    return _mm(prec, _rmsnorm(x, p["final_norm"]["scale"], eps), p["lm_head"]), torch.zeros(())


def matmul_params(conf):
    d, k, moe = conf["d_model"], conf["first_dense"], conf["moe"]
    qd, kvd = conf["n_heads"] * conf["head_dim"], conf["n_kv_heads"] * conf["head_dim"]
    expert_layer = d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
    return (conf["n_layers"] * (2 * d * qd + 2 * d * kvd) + k * 3 * d * conf["d_ff"]
            + (conf["n_layers"] - k) * expert_layer + d * conf["vocab_size"])


def attention_flops(conf, seq):
    return _dec.attention_flops(conf, seq)


def smoke(conf, dtype):
    return dict(conf, dtype=dtype)
'''


def _tree_bytes(root: Path) -> dict:
    return {str(f.relative_to(root)): f.read_bytes() for f in sorted(root.rglob("*"))
            if f.is_file() and "__pycache__" not in f.parts}


def test_new_family_is_found_without_an_edit(tmp_path):
    """A model family, a configuration naming it and a cell added as files:
    the harness's names, the port's fields, the weights, the reference and
    the FLOP count all come from the new family, and no other file changes."""
    from repro_torch.configs import get_model_config

    before = _tree_bytes(HERE), (HERE.parent / "BENCHMARK.json").read_bytes()
    for d in ("configs", "workloads", "traffic", "metrics", "families"):
        shutil.copytree(HERE / d, tmp_path / d, ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "families" / "dense_then_experts.py").write_text(TEST_FAMILY)
    (tmp_path / "configs" / "dte-tiny.json").write_text(json.dumps({
        "name": "dte-tiny", "model": "olmoe-1b-7b", "family": "dense_then_experts",
        "hidden_size": 32, "intermediate_size": 96, "moe_intermediate_size": 48,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 8,
        "num_hidden_layers": 3, "first_k_dense_replace": 1, "n_routed_experts": 8,
        "num_experts_per_tok": 3, "vocab_size": 128, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-6, "dtype": "float32", "remat": False, "reduced": {}}))
    (tmp_path / "workloads" / "dte-tiny-fedrank.json").write_text(json.dumps(
        {"config": "dte-tiny", "traffic": "fl-lm-fedrank-k4", "chips": 1, "why": "-"}))

    _, conf, _ = bench.load_cell("dte-tiny-fedrank", root=tmp_path)
    fam = families.of(conf)
    assert Path(fam.__file__) == (tmp_path / "families" / "dense_then_experts.py").resolve()
    assert conf["first_dense"] == 1 and conf["d_ff"] == 96
    assert conf["moe"] == {"n_experts": 8, "top_k": 3, "d_ff_expert": 48}
    base = get_model_config("olmoe-1b-7b")
    assert bench.port_config(conf) == dataclasses.replace(
        base, n_layers=3, d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, d_ff=96,
        vocab_size=128, rope_theta=10000.0, dtype="float32", remat=False,
        moe=dataclasses.replace(base.moe, n_experts=8, top_k=3, d_ff_expert=48))

    p = model_weights(conf, 2 ** 31 + 7, "cpu")
    shapes = {n: tuple(t.shape) for n, t in ref_model.leaves(p).items()}
    assert shapes["dense/mlp/up"] == (1, 32, 96) and shapes["experts/moe/up"] == (2, 8, 32, 48)
    again = ref_model.leaves(model_weights(conf, 2 ** 31 + 7, "cpu"))
    assert all(again[n].equal(t) for n, t in ref_model.leaves(p).items())
    tokens = torch.randint(0, 128, (2, 16), generator=torch.Generator().manual_seed(1))
    logits, _ = ref_model.forward(p, conf, tokens)
    assert logits.shape == (2, 16, 128) and logits.dtype == torch.float32
    assert torch.isfinite(logits).all()
    new, loss = ref_model.sgd_step(p, conf, tokens, tokens.roll(-1, 1), 0.1)
    assert math.isfinite(loss) and set(ref_model.leaves(new)) == set(shapes)
    assert not ref_model.leaves(new)["experts/moe/up"].equal(ref_model.leaves(p)["experts/moe/up"])

    attn = 2 * 32 * 32 + 2 * 32 * 16
    per = 3 * attn + 3 * 32 * 96 + 2 * (32 * 8 + 3 * 3 * 32 * 48) + 32 * 128
    assert flops.matmul_params(conf) == per == 50_688
    att = 2.0 * 16 * 17 * 8 * 4 * 3
    assert flops.round_flops(conf, 16, 10, 2) == (10 * (6 * per * 16 + 3 * att)
                                                  + 2 * (2 * per * 16 + att))
    assert (_tree_bytes(HERE), (HERE.parent / "BENCHMARK.json").read_bytes()) == before


# model_dims and port_config of each configuration, as they were before the
# architecture-specific code moved out of bench.py into families/decoder.py
DECODER_DIMS = {
    "yi-6b-fl": {"n_layers": 2, "d_model": 4096, "n_heads": 32, "n_kv_heads": 4, "head_dim": 128,
                 "d_ff": 11008, "vocab_size": 64000, "rope_theta": 5000000.0, "norm_eps": 1e-06,
                 "name": "yi-6b-fl", "model": "yi-6b", "dtype": "bfloat16", "remat": True},
    "olmoe-1b-7b-fl": {"n_layers": 1, "d_model": 2048, "n_heads": 16, "n_kv_heads": 16,
                       "head_dim": 128, "d_ff": 1024, "vocab_size": 50304, "rope_theta": 10000.0,
                       "norm_eps": 1e-06, "name": "olmoe-1b-7b-fl", "model": "olmoe-1b-7b",
                       "dtype": "bfloat16", "remat": True,
                       "moe": {"n_experts": 64, "top_k": 8, "load_balance_coef": 0.01,
                               "router_z_coef": 0.001, "capacity_factor": 1.25,
                               "norm_topk_prob": True, "d_ff_expert": 1024}},
}


def _decoder_port(name: str):
    from repro_torch.configs import ModelConfig, MoEConfig

    common = dict(activation="silu", norm="rmsnorm", attention="full", window=None,
                  use_rope=True, tie_embeddings=False, logit_softcap=0.0, ssm=None,
                  frontend=None, enc_dec=False, n_enc_layers=0, enc_seq=0, dtype="bfloat16",
                  remat=True, kv_cache_dtype="")
    if name == "yi-6b-fl":
        return ModelConfig(name="yi-6b", family="dense", citation="arXiv:2403.04652",
                           n_layers=2, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
                           d_ff=11008, vocab_size=64000, rope_theta=5000000.0, moe=None, **common)
    return ModelConfig(name="olmoe-1b-7b", family="moe", citation="arXiv:2409.02060", n_layers=1,
                       d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1024,
                       vocab_size=50304, rope_theta=10000.0,
                       moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, capacity_factor=1.25,
                                     router_jitter=0.0, load_balance_coef=0.01,
                                     router_z_coef=0.001, dispatch="sort", n_groups=1),
                       **common)


@pytest.mark.parametrize("name", sorted(DECODER_DIMS))
def test_configurations_without_a_family_are_decoders(name):
    raw = json.loads((HERE / "configs" / f"{name}.json").read_text())
    assert "family" not in raw
    conf = bench.model_dims(raw)
    assert families.of(conf) is families.load("decoder")
    assert conf == DECODER_DIMS[name]
    assert bench.port_config(conf) == _decoder_port(name)


def test_families_import_nothing_of_the_port():
    """The reference runs the families' forwards: they import nothing of
    the port either."""
    files = sorted((HERE / "families").rglob("*.py"))
    assert files
    for f in files:
        for name in _imports(f):
            assert name.split(".")[0] not in {"repro_torch", "jax", "jaxlib", "flax", "repro"}, (
                f, name)


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
