"""The port stands alone and never falls back to the CPU on its own.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports ``jax``
  or anything of the JAX package ``repro``.
* Entry points asked for ``cuda`` (or left to their default, the card) on a
  machine without one raise; they do not quietly run on the CPU.
* Configurations a slice of the port refused until it was ported now run:
  every FL feature, every family of the LM zoo.
* Every module of the port that has a counterpart in ``repro`` carries its
  public names (top-level ``def``/``class`` and ``__all__``), except names
  that ``ROADMAP.md`` queues for a later slice or records as replaced by the
  port's own design (the Pallas kernels and their backend switches).
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.convert import params_from_numpy
from repro_torch.core.imitation import augment_demonstrations, pretrain_qnet
from repro_torch.core.qnet import init_qnet
from repro_torch.data import FederatedData, dirichlet_partition, make_classification_data
from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy
from repro_torch.launch.train import train

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_files_exist():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for want in ("chip_smoke.py", "src/repro_torch/fl/server.py",
                 "src/repro_torch/core/fedrank.py",
                 "src/repro_torch/kernels/select_topk/kernel.py",
                 "src/repro_torch/kernels/_build.py",
                 "src/repro_torch/kernels/pairwise_rank/kernel.py",
                 "src/repro_torch/kernels/pairwise_rank/ops.py",
                 "src/repro_torch/kernels/pairwise_rank/ref.py",
                 "src/repro_torch/core/experts.py",
                 "src/repro_torch/core/imitation.py",
                 "src/repro_torch/core/baselines.py",
                 "src/repro_torch/kernels/fleet_state/kernel.py",
                 "src/repro_torch/kernels/fleet_state/ops.py",
                 "src/repro_torch/kernels/fleet_state/ref.py",
                 "src/repro_torch/fl/traces/trace.py",
                 "src/repro_torch/fl/traces/synthetic.py",
                 "src/repro_torch/fl/traces/models.py",
                 "src/repro_torch/fl/async_engine.py",
                 "src/repro_torch/configs/base.py",
                 "src/repro_torch/configs/yi_6b.py",
                 "src/repro_torch/kernels/flash_attention/kernel.py",
                 "src/repro_torch/kernels/flash_attention/ops.py",
                 "src/repro_torch/kernels/flash_attention/ref.py",
                 "src/repro_torch/models/attention.py",
                 "src/repro_torch/models/transformer.py",
                 "src/repro_torch/launch/steps.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/scheduler.py",
                 "src/repro_torch/models/ssm.py",
                 "src/repro_torch/kernels/mamba/kernel.py",
                 "src/repro_torch/kernels/mamba/ops.py",
                 "src/repro_torch/kernels/mamba/ref.py",
                 "src/repro_torch/kernels/rwkv6/kernel.py",
                 "src/repro_torch/kernels/rwkv6/ops.py",
                 "src/repro_torch/kernels/rwkv6/ref.py",
                 "src/repro_torch/kernels/sgd_update/kernel.py",
                 "src/repro_torch/kernels/sgd_update/ops.py",
                 "src/repro_torch/kernels/sgd_update/ref.py",
                 "src/repro_torch/optim/optimizers.py",
                 "src/repro_torch/optim/schedules.py",
                 "src/repro_torch/checkpoint/msgpack_ckpt.py",
                 "src/repro_torch/models/flash_xla.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/sharding.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/launch/roofline.py",
                 "src/repro_torch/launch/hlo_cost.py",
                 "src/repro_torch/models/sharding.py"):
        assert want in names
    for cu in ("pairwise_rank", "select_topk", "fleet_state", "flash_attention",
               "mamba", "rwkv6", "sgd_update"):
        assert (ROOT / f"src/repro_torch/csrc/{cu}.cu").is_file()
    assert (ROOT / "src/repro_torch/fl/traces/data/sample_livelab.csv").is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_and_no_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax"), (path, mod)


# Public names of a reference module that its port may lack, each named in
# ROADMAP.md: queued for a later slice (section 1; none is left) ...
QUEUED = {}
# ... or replaced by the port's design (section 2): name -> the port's name
# in the same module that takes its place
REPLACED = {
    "kernels/select_topk/kernel.py": {"select_topk_pallas": "select_topk_cuda"},
    "kernels/pairwise_rank/kernel.py": {"pairwise_rank_pallas": "pairwise_rank_fwd_cuda"},
    "kernels/fleet_state/kernel.py": {"segment_index_pallas": "segment_index_cuda"},
    "kernels/flash_attention/kernel.py": {"flash_attention_folded": "flash_attention_cuda"},
    "kernels/mamba/kernel.py": {"selective_scan_pallas": "selective_scan_cuda"},
    "kernels/rwkv6/kernel.py": {"wkv6_pallas": "wkv6_cuda"},
    "kernels/select_topk/ops.py": {"resolve_select_impl": "select_topk"},
    "kernels/pairwise_rank/ops.py": {"resolve_rank_impl": "pairwise_rank",
                                     "pairwise_rank_loss": "pairwise_rank"},
    "kernels/fleet_state/ops.py": {"resolve_fleet_state_impl": "segment_index"},
    "kernels/flash_attention/ops.py": {"attention": "flash_attention"},
    "core/features.py": {"featurize_jnp": "featurize"},
    # the reference parses compiled HLO text; the port counts the ops a
    # step dispatches on its local shards
    "launch/hlo_cost.py": {"parse_hlo": "CostCounter", "analyze": "analyze_step",
                           "analyze_hlo_text": "analyze_step", "Op": "CostCounter",
                           "Computation": "CostCounter", "shape_bytes": "tensor_bytes",
                           "shape_elems": "tensor_elems", "shape_dims": "tensor_elems"},
}


def _public_names(path: Path):
    """Top-level public def/class names, and ``__all__`` (or None)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    defs, exported = set(), None
    for node in tree.body:
        if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                and not node.name.startswith("_")):
            defs.add(node.name)
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            exported = set(ast.literal_eval(node.value))
    return defs, exported


PORT_PKG, REF_PKG = ROOT / "src" / "repro_torch", ROOT / "src" / "repro"
MODULE_PAIRS = sorted(p.relative_to(PORT_PKG).as_posix() for p in PORT_PKG.rglob("*.py")
                      if (REF_PKG / p.relative_to(PORT_PKG)).is_file())


@pytest.mark.parametrize("rel", MODULE_PAIRS)
def test_ported_modules_keep_the_reference_public_names(rel):
    ref_defs, ref_all = _public_names(REF_PKG / rel)
    defs, exported = _public_names(PORT_PKG / rel)
    allowed = QUEUED.get(rel, set()) | set(REPLACED.get(rel, {}))
    assert ref_defs - defs <= allowed, sorted(ref_defs - defs - allowed)
    if ref_all is not None:
        assert exported is not None, f"{rel} has no __all__"
        assert ref_all - exported <= allowed, sorted(ref_all - exported - allowed)
    # no stale entry: what is allowed is still missing, and what replaces it is there
    assert not (allowed & (defs | (exported or set()))), sorted(allowed & defs)
    for name, ours in REPLACED.get(rel, {}).items():
        assert ours in defs | (exported or set()), (name, ours)


def test_every_reference_module_has_a_counterpart():
    """The port is whole: each ``.py`` of ``src/repro`` has its namesake under
    ``src/repro_torch``."""
    missing = sorted(p.relative_to(REF_PKG).as_posix() for p in REF_PKG.rglob("*.py")
                     if not (PORT_PKG / p.relative_to(REF_PKG)).is_file())
    assert not missing, missing


def test_every_allowed_missing_name_is_in_the_roadmap():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    assert set(QUEUED) | set(REPLACED) <= set(MODULE_PAIRS)
    names = set().union(*QUEUED.values(), *(set(r) for r in REPLACED.values()))
    assert not [n for n in sorted(names) if n not in roadmap]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal path is not reachable")


def _tiny_data():
    tr, te = make_classification_data(n_samples=400, seed=0)
    return FederatedData(tr, te, dirichlet_partition(tr.y, 10, 0.5, seed=0))


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_entry_points_refuse_missing_card(device):
    _no_card()
    with pytest.raises(RuntimeError, match="cuda"):
        repro_torch.resolve_device(device)
    with pytest.raises(RuntimeError, match="cuda"):
        init_qnet(0, device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        MLPTask().init(0, device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({"w": np.zeros((2, 2), np.float32)}, device)
    with pytest.raises(RuntimeError, match="cuda"):
        build_policy("fedrank", k=3, device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        build_policy("favor", device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        pretrain_qnet(augment_demonstrations([], n_synthetic=2), steps=1,
                      device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        FLServer(FLConfig(n_devices=10, k_select=2), MLPTask(), _tiny_data(),
                 device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        train("yi-6b", steps=1, batch=1, seq=8, verbose=False, device=device)


def test_cpu_is_explicit():
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
    q = init_qnet(0, device="cpu")
    assert all(t.device.type == "cpu" for t in q.values())


@pytest.mark.parametrize("field,value,slice_name", [
    ("topology", "regions", None),
    ("regions", 3, None),
    ("attack", "signflip", None),
    ("aggregator", "krum", None),
    ("observe", True, None),
])
def test_unported_config_is_refused(field, value, slice_name):
    """Every feature once refused here now runs one round: the hierarchy,
    the attacks, robust aggregation and the observed round, whose record
    holds the round's spans."""
    from repro_torch.fl.attacks import SignFlip

    if value == "signflip":
        value = SignFlip(fraction=0.5, scale=2.0)
    cfg = FLConfig(n_devices=10, k_select=2, rounds=1, l_ep=1, **{field: value})
    if slice_name is not None:
        with pytest.raises(NotImplementedError, match=slice_name):
            FLServer(cfg, MLPTask(), _tiny_data(), device="cpu")
        return
    srv = FLServer(cfg, MLPTask(), _tiny_data(), device="cpu")
    hist = srv.run(build_policy("fedavg"))
    assert len(hist) == 1 and np.isfinite(hist[0].acc)
    assert all(t.device.type == "cpu" and bool(torch.isfinite(t).all())
               for t in srv.global_params.values())
    if field in ("topology", "regions"):
        assert srv.topology is not None and hist[0].tier_staleness
    if field == "observe":
        from repro_torch.obs import clear_profiler

        clear_profiler(srv.obs)
        rounds = [r for r in srv.obs.records if r["type"] == "round"]
        assert len(rounds) == 1 and "aggregate" in {s["span"] for s in rounds[0]["spans"]}


def test_unknown_policy_lists_registered():
    with pytest.raises(KeyError, match="fedrank-IP"):
        build_policy("no-such-policy")


@pytest.mark.parametrize("kw", [
    dict(mode="async"),
    dict(executor="async"),
    dict(mode="async", scenario="trace-synthetic-week"),
    dict(scenario="trace-livelab"),
    dict(trace_csv="SAMPLE"),
])
def test_async_and_trace_replay_are_ported(kw):
    from repro_torch.fl.traces import sample_trace_path

    kw = {k: (sample_trace_path() if v == "SAMPLE" else v) for k, v in kw.items()}
    srv = FLServer(FLConfig(n_devices=10, k_select=2, rounds=1, l_ep=1, **kw),
                   MLPTask(), _tiny_data(), device="cpu")
    hist = srv.run(build_policy("fedavg"))
    assert len(hist) == 1 and np.isfinite(hist[0].acc)


def test_unknown_mode_is_an_error():
    with pytest.raises(ValueError, match="mode"):
        FLServer(FLConfig(n_devices=10, k_select=2, mode="asynchronous"),
                 MLPTask(), _tiny_data(), device="cpu")


def test_async_pieces_of_later_slices_refuse():
    """Both pieces a later slice had to bring now run: the vmapped inner
    executor and a robust buffered merge."""
    from repro_torch.fl import buffered_aggregate, executor_label, make_executor

    ex = make_executor("async", inner="vmapped")
    assert executor_label(ex) == "async[vmapped]"
    p = {"w": torch.zeros(2)}
    q = {"w": torch.ones(2)}
    out = buffered_aggregate(p, [p, q, q], [1.0, 1.0, 1.0], [0, 0, 0],
                             robust="trimmed_mean")
    assert torch.equal(out["w"], torch.ones(2))


@pytest.mark.parametrize("device", [None, "cuda"])
def test_trace_lookups_refuse_missing_card(device):
    _no_card()
    from repro_torch.fl import build_scenario
    from repro_torch.fl.traces import TraceSpec, sample_trace_path

    with pytest.raises(RuntimeError, match="cuda"):
        build_scenario("trace-synthetic-week", 10, device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        TraceSpec(csv=sample_trace_path()).resolve(10, device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        FLServer(FLConfig(n_devices=10, k_select=2, mode="async",
                          scenario="trace-livelab"),
                 MLPTask(), _tiny_data(), device=device)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_lm_serving_refuses_missing_card(device):
    _no_card()
    from repro_torch.configs import get_model_config
    from repro_torch.launch.scheduler import ContinuousBatcher
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T

    cfg = get_model_config("yi-6b", smoke=True)
    with pytest.raises(RuntimeError, match="cuda"):
        T.init_params(0, cfg, device)
    with pytest.raises(RuntimeError, match="cuda"):
        serve("yi-6b", smoke=True, batch=1, prompt_len=4, gen=1, device=device)
    params = T.init_params(0, cfg, "cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ContinuousBatcher(cfg, params, batch_slots=1, max_len=8, device=device)
    with pytest.raises(RuntimeError, match="cuda"):
        params_from_numpy({"layers": {"w": np.zeros((2, 2), np.float32)}}, device)


@pytest.mark.parametrize("arch,slice_name", [
    ("olmoe-1b-7b", "MoE"),
    ("phi3.5-moe", "MoE"),
    ("whisper-medium", "encoder-decoder"),
    ("internvl2-76b", "frontend"),
])
def test_unported_lm_families_are_refused(arch, slice_name):
    """The four families once refused here (the MoE models, whisper's
    encoder-decoder, InternVL2's frontend) init, forward, prefill and
    serve on the CPU when asked; ``check_supported`` refuses only an
    unknown attention kind, and a model with a frontend refuses to run
    without its embeddings, naming them."""
    import dataclasses

    from repro_torch.configs import get_model_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T

    cfg = get_model_config(arch, smoke=True)
    T.check_supported(cfg)
    with pytest.raises(ValueError, match="attention kind"):
        T.check_supported(dataclasses.replace(cfg, attention="linear"))
    params = T.init_params(0, cfg, "cpu")
    assert all(t.device.type == "cpu" for t in _leaves(params))
    assert ("moe" in params["layers"]) == (slice_name == "MoE")
    assert ("encoder" in params) == (slice_name == "encoder-decoder")
    tokens = torch.zeros((1, 4), dtype=torch.int64)
    fe = None
    if cfg.frontend is not None:
        n = cfg.enc_seq if cfg.enc_dec else cfg.frontend.n_tokens
        fe = torch.zeros((1, n, cfg.frontend.embed_dim))
        with pytest.raises(ValueError, match="frontend_embeds"):
            T.forward(params, cfg, tokens)
    logits, aux = T.forward(params, cfg, tokens, fe)
    front = cfg.frontend.n_tokens if slice_name == "frontend" else 0
    assert logits.shape == (1, front + 4, cfg.vocab_size)
    assert (float(aux) > 0) == (slice_name == "MoE")
    last, st = T.prefill(params, cfg, tokens, fe, max_len=8, impl="flash", last_only=True)
    assert last.shape == (1, 1, cfg.vocab_size) and int(st.step[0]) == front + 4
    assert (st.cross_kv is not None) == (slice_name == "encoder-decoder")
    stats = serve(arch, smoke=True, batch=1, prompt_len=4, gen=1, verbose=False,
                  device="cpu")
    assert stats["decode_tok_per_s"] > 0


def _scan_args(dtype=torch.float32, device="cpu"):
    b, t, inner, state = 1, 3, 4, 2
    shapes = ((b, t, inner), (b, t, inner), (b, t, state), (b, t, state),
              (inner, state), (b, inner, state))
    return [torch.zeros(sh, dtype=dtype, device=device) for sh in shapes]


def _wkv_args(dtype=torch.float32, device="cpu"):
    b, t, h, n = 1, 3, 2, 4
    shapes = ((b, t, h, n),) * 4 + ((h, n), (b, h, n, n))
    return [torch.zeros(sh, dtype=dtype, device=device) for sh in shapes]


def _ssm_wrapper(name):
    from repro_torch.kernels.mamba.kernel import selective_scan_cuda
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda

    return {"mamba": (selective_scan_cuda, _scan_args),
            "rwkv6": (wkv6_cuda, _wkv_args)}[name]


@pytest.mark.parametrize("name", ["mamba", "rwkv6"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16, torch.float16])
def test_ssm_kernel_wrappers_refuse_other_dtypes(name, dtype):
    fn, args = _ssm_wrapper(name)
    with pytest.raises(ValueError, match="float32"):
        fn(*args(dtype))
    mixed = args()
    mixed[1] = mixed[1].to(dtype)
    with pytest.raises(ValueError, match="float32"):
        fn(*mixed)


@pytest.mark.parametrize("name", ["mamba", "rwkv6"])
def test_ssm_kernel_wrappers_refuse_other_devices(name):
    fn, args = _ssm_wrapper(name)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fn(*args(device="meta"))
    mixed = args()
    mixed[0] = mixed[0].to("meta")
    with pytest.raises(ValueError, match="is on"):
        fn(*mixed)
    launches = fn.launches
    fn(*args())                       # the CPU takes the plain version
    assert fn.launches == launches


@pytest.mark.parametrize("name", ["mamba", "rwkv6"])
def test_ssm_kernel_wrappers_refuse_malformed_shapes(name):
    fn, args = _ssm_wrapper(name)
    bad = args()
    bad[-1] = bad[-1][..., :1]        # the state's last dimension cut
    with pytest.raises(ValueError, match="shape"):
        fn(*bad)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_ssm_families_run_on_the_cpu_when_asked(arch):
    from repro_torch.configs import get_model_config
    from repro_torch.models import transformer as T

    cfg = get_model_config(arch, smoke=True)
    T.check_supported(cfg)
    params = T.init_params(0, cfg, "cpu")
    assert all(t.device.type == "cpu" for t in _leaves(params))
    logits, _ = T.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int64), impl="flash")
    assert logits.shape == (1, 4, cfg.vocab_size)
