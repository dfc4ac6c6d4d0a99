"""The dry-run, the cost counter and the roofline of the port.

Each group-initialising case runs in a process of its own (a process has
one default group), all started together by one fixture:

* ``python -m repro_torch.launch.dryrun --smoke --mesh 2x4 --device cpu``
  gives ``ok`` for every arch's smoke config in each mode (train with the
  AdamW update, prefill, decode) on a fake 2x4 mesh, and its records make
  roofline rows;
* ``--impl flash`` is refused with a message that names the kernel route;
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
    start("flash", ["-m", "repro_torch.launch.dryrun", "--arch", "yi-6b", "--shape",
                    "train_4k", "--impl", "flash", "--device", "cpu"])
    start("mlp", ["-c", MLP, str(tmp / "mlp.json")])
    out = {name: (p.communicate(timeout=600)[0], p.returncode) for name, p in jobs.items()}
    recs = []
    for i in range(len(groups)):
        log, rc = out[f"smoke{i}"]
        assert rc == 0, log[-3000:]
        recs += json.loads((tmp / f"smoke{i}.json").read_text())
    log, rc = out["mlp"]
    assert rc == 0, log[-3000:]
    return {"records": {(r["arch"], r["shape"]): r for r in recs},
            "flash": out["flash"], "mlp": json.loads((tmp / "mlp.json").read_text())}


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


def test_dry_run_refuses_the_kernel_route(runs):
    log, rc = runs["flash"]
    assert rc != 0
    assert "flash_attention" in log and "impl='flash'" in log


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
