"""The dry-run, the cost counter and the roofline of the port.

Each group-initialising case runs in a process of its own (a process has
one default group), all started together by one fixture:

* ``python -m repro_torch.launch.dryrun --smoke --mesh 2x4 --device cpu``
  gives ``ok`` for every arch's smoke config in each mode (train with the
  AdamW update, prefill, decode) on a fake 2x4 mesh, and its records make
  roofline rows;
* ``--all --smoke --mesh 2x4 --device cpu --impl flash`` gives ``ok`` for
  every prefill and decode combination, counted through the kernel ops
  (``repro_torch::flash_attention``, ``::selective_scan``, ``::wkv6``, one
  call a layer), and a ``skipped`` record naming the missing backward for
  every ``train_4k``;
* on a fake 1x1 mesh, Yi's smoke prefill under ``naive`` and under
  ``flash`` differ in ``dot_flops_per_device`` by exactly the naive route's
  two full (S, S) products less the kernel's masked count, a layer each;
* ``--all --smoke --mesh 4x2 --batch 2 --device cpu`` (a batch smaller than
  the ``data`` axis) gives ``ok`` or ``skipped`` everywhere;
* on a fake 2x4 mesh, a column-then-row-parallel MLP's per-device FLOPs are
  exactly ``2MNK/g`` per product (no global-shape op counted as well), and
  its collective bytes follow the ring model.

``skip_reason`` is compared with the reference's for every arch and shape.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma-7b", "h2o-danube-3-4b", "hymba-1.5b", "internvl2-76b", "minitron-4b",
         "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "rwkv6-3b", "whisper-medium", "yi-6b"]
SHAPES = ["train_4k", "prefill_32k", "decode_32k"]
M, K, N = 8, 64, 128

MLP = f'''
import json, sys
import torch, torch.distributed as dist
from repro_torch.launch.dryrun import fake_mesh
from repro_torch.launch.hlo_cost import analyze_step
from repro_torch.launch.sharding import P, distribute_params
mesh = fake_mesh((2, 4), ("data", "model"), "cpu")
meta = {{"x": torch.empty({M}, {K}, device="meta"), "w1": torch.empty({K}, {N}, device="meta"),
        "w2": torch.empty({N}, {K}, device="meta")}}
specs = {{"x": P("data", None), "w1": P(None, "model"), "w2": P("model", None)}}
d = distribute_params(meta, mesh, specs, local_device="meta")
# column-parallel, then row-parallel: a pending sum, made whole
c = analyze_step(lambda: (torch.relu(d["x"] @ d["w1"]) @ d["w2"]).redistribute(
    mesh, d["x"].placements), mesh=mesh)
json.dump(c.__dict__, open(sys.argv[1], "w"))
dist.destroy_process_group()
'''


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def runs():
    tmp = Path(tempfile.mkdtemp(prefix="dryrun_"))
    jobs = {}

    def start(name, argv):
        jobs[name] = subprocess.Popen([sys.executable] + argv, env=_env(), cwd=str(ROOT),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)

    groups = [ARCHS[i::5] for i in range(5)]
    for i, archs in enumerate(groups):
        start(f"smoke{i}", ["-m", "repro_torch.launch.dryrun", "--smoke", "--mesh", "2x4",
                            "--device", "cpu", "--arch", ",".join(archs),
                            "--shape", ",".join(SHAPES), "--out", str(tmp / f"smoke{i}.json")])
    start("flash", ["-m", "repro_torch.launch.dryrun", "--all", "--smoke", "--mesh", "2x4",
                    "--device", "cpu", "--impl", "flash", "--out", str(tmp / "flash.json")])
    for impl in ("naive", "flash"):
        start(f"yi1x1_{impl}", ["-m", "repro_torch.launch.dryrun", "--arch", "yi-6b",
                                "--shape", "prefill_32k", "--smoke", "--mesh", "1x1",
                                "--device", "cpu", "--impl", impl,
                                "--out", str(tmp / f"yi1x1_{impl}.json")])
    # --all, its archs split over two processes
    for i in range(2):
        start(f"batch{i}", ["-m", "repro_torch.launch.dryrun", "--smoke", "--mesh", "4x2",
                            "--batch", "2", "--device", "cpu", "--arch", ",".join(ARCHS[i::2]),
                            "--out", str(tmp / f"batch{i}.json")])
    start("mlp", ["-c", MLP, str(tmp / "mlp.json")])
    out = {name: (p.communicate(timeout=600)[0], p.returncode) for name, p in jobs.items()}

    def _mlp(out, tmp):
        log, rc = out["mlp"]
        assert rc == 0, log[-3000:]
        return json.loads((tmp / "mlp.json").read_text())

    def records(*names):
        recs = []
        for name in names:
            log, rc = out[name]
            assert rc == 0, log[-3000:]
            recs += json.loads((tmp / f"{name}.json").read_text())
        return {(r["arch"], r["shape"]): r for r in recs}

    return {"records": records(*(f"smoke{i}" for i in range(len(groups)))),
            "flash": records("flash"), "batch": records("batch0", "batch1"),
            "yi1x1": {impl: records(f"yi1x1_{impl}")[("yi-6b", "prefill_32k")]
                      for impl in ("naive", "flash")},
            "mlp": _mlp(out, tmp)}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_dry_run_partitions_on_a_fake_2x4_mesh(runs, arch, shape):
    from repro_torch.launch.roofline import row_from_record

    rec = runs["records"][(arch, shape)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["mesh"] == "2x4" and rec["chips"] == 8
    assert rec["counter_check"]["dot_flops"] == rec["counter_check"]["expected"] > 0
    hlo = rec["hlo"]
    assert hlo["flops_per_device"] >= hlo["dot_flops_per_device"] > 0
    assert hlo["bytes_per_device"] > 0 and hlo["collective_wire_bytes"] > 0
    assert set(hlo["collective_wire_bytes_by_axis"]) <= {"data", "model"}
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["output_size_in_bytes"] > 0
    assert "memory.temp_size_in_bytes" in rec["not_measured"]
    assert "compile_s" in rec["not_measured"] and rec["seconds"] > 0
    row = row_from_record(rec)
    assert row.dominant in ("compute", "memory", "collective") and row.compute_s > 0


def _kernel_calls(arch, mode):
    """The kernel ops one smoke step goes through, a call a layer."""
    from repro_torch.configs import get_model_config

    cfg = get_model_config(arch, smoke=True)
    n = cfg.n_layers
    if arch == "rwkv6-3b":
        return {"repro_torch::wkv6": n}
    calls = {}
    if mode == "prefill":
        calls["repro_torch::flash_attention"] = n + (cfg.n_enc_layers if cfg.enc_dec else 0)
    if arch == "hymba-1.5b":
        calls["repro_torch::selective_scan"] = n
    return calls


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_flash_dry_run_goes_through_the_kernel_ops(runs, arch, shape):
    rec = runs["flash"][(arch, shape)]
    assert rec["impl"] == "flash" and rec["mesh"] == "2x4"
    if rec["mode"] == "train":
        assert rec["status"] == "skipped"
        assert "no backward" in rec["reason"] and "flash_attention" in rec["reason"]
        return
    assert rec["status"] == "ok", rec.get("error")
    assert rec["hlo"]["kernel_calls"] == _kernel_calls(arch, rec["mode"])
    assert rec["hlo"]["flops_per_device"] >= rec["hlo"]["dot_flops_per_device"] > 0


def test_flash_route_counts_the_kernels_masked_products(runs):
    """Yi's smoke prefill on a 1x1 mesh: the naive route's two (S, S)
    products, 4 B H S^2 Dh a layer, become the kernel's formula over the
    causal pairs; every other product is counted alike."""
    from repro_torch.configs import get_model_config
    from repro_torch.kernels.work import flash_flops
    from repro_torch.models.transformer import _window

    cfg = get_model_config("yi-6b", smoke=True)
    naive, flash = runs["yi1x1"]["naive"], runs["yi1x1"]["flash"]
    assert naive["status"] == flash["status"] == "ok"
    b, s = flash["cut"]["global_batch"], flash["cut"]["seq_len"]
    h, dh = cfg.n_heads, cfg.head_dim
    diff = naive["hlo"]["dot_flops_per_device"] - flash["hlo"]["dot_flops_per_device"]
    assert diff == cfg.n_layers * (4 * b * h * s * s * dh
                                   - flash_flops(b, s, h, dh, True, _window(cfg)))
    assert flash["hlo"]["kernel_calls"] == {"repro_torch::flash_attention": cfg.n_layers}


@pytest.mark.parametrize("arch", ARCHS)
def test_dry_run_with_a_batch_below_the_data_axis(runs, arch):
    """Batch 2 on a 4x2 mesh: the batch stays whole on ``data``; RWKV6's
    train step once failed there in DTensor's backward."""
    recs = [r for (a, _), r in runs["batch"].items() if a == arch]
    assert len(recs) == 4
    for rec in recs:
        assert rec["status"] in ("ok", "skipped"), (rec["shape"], rec.get("error"))
        assert rec["cut"]["global_batch"] == 2 and rec["mesh"] == "4x2"


def test_counter_gives_exact_per_device_flops_on_a_sharded_mlp(runs):
    c = runs["mlp"]
    g = 8
    assert c["dot_flops"] == 2 * (2 * M * N * K) / g      # no global-shape double count
    # the row-parallel product's pending sum: one all-reduce over "model" (4)
    ar = (M // 2) * K * 4
    assert c["coll_bytes"] == {"all-reduce": ar}
    assert c["coll_wire"] == 2 * (4 - 1) / 4 * ar
    assert c["coll_wire_by_axis"] == {"model": c["coll_wire"]}
    assert c["flops"] == c["dot_flops"] + (M // 2) * (N // 4)   # the relu


def test_skip_reason_is_the_reference():
    from repro.configs import INPUT_SHAPES
    from repro.configs import get_model_config as ref_cfg

    # the reference's dry-run sets XLA_FLAGS when imported: keep this
    # process's value
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import skip_reason as ref_skip
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved

    from repro_torch.configs import get_model_config, get_shape
    from repro_torch.launch.dryrun import skip_reason

    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            assert (skip_reason(get_model_config(arch), get_shape(shape.name))
                    == ref_skip(ref_cfg(arch), shape))
