"""The mesh tooling of the port against the live reference.

* ``build_rules``, ``param_specs`` (train and decode, with and without
  ``fsdp_on_output``) and ``decode_state_specs`` equal the reference's entry
  for entry, leaf by leaf in the reference's order, for every arch x input
  shape x mesh (1x1, 2x4, 16x16, 2x16x16; the reference side takes its own
  ``FakeMesh`` duck type, so JAX needs no devices), and no spec repeats a
  mesh axis.
* The five stand-ins of ``launch/steps.py`` have the shapes and dtypes of
  the reference's ``jax.eval_shape`` results, leaf by leaf.
* ``roofline.model_flops`` is exactly the reference's; ``_collective_cost``'s
  ring fractions are the reference's for each collective kind and group size.
* On two gloo ranks, a ``(1, 2)`` model mesh and a ``(2, 1)`` data mesh: the
  yi, hymba, rwkv6 and olmoe smoke models' prefill logits, 4 decode steps
  and one train step's loss and gradients against a one-process plain run
  (RWKV6's also with a batch smaller than the ``data`` axis: batch 1 on
  the data mesh, and batch 2 on eight ranks as a (4, 2) mesh), and
  ``VmappedExecutor(mesh=)`` against ``mesh=None``.  Both meshes' rank
  pairs run at once, each in processes of their own (a process has one
  default group), from ``python tests/test_torch_mesh.py gloo ...``.

Gradients are held to 1e-5 of each leaf's largest entry, or to 4x the
plain run's own change when every weight moves by one ulp, where that is
larger: tensor parallelism sums a row-parallel product in two parts, and
RWKV6's time-mix gradients move by 2.6e-5 of their scale under a one-ulp
change of its weights.
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["gemma-7b", "h2o-danube-3-4b", "hymba-1.5b", "internvl2-76b", "minitron-4b",
         "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "rwkv6-3b", "whisper-medium", "yi-6b"]
MESHES = [((1, 1), ("data", "model")), ((2, 4), ("data", "model")),
          ((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model"))]
GLOO_ARCHS = ["yi-6b", "hymba-1.5b", "rwkv6-3b", "olmoe-1b-7b"]
GLOO_MESHES = [(1, 2), (2, 1)]


def _fake_mesh(shape, axes):
    class FakeMesh:
        axis_names = axes
        devices = np.empty(shape)
    return FakeMesh()


def _ref_path(path):
    out = []
    for k in path:
        if hasattr(k, "key"):
            out.append(str(k.key))
        elif hasattr(k, "name"):
            out.append(str(k.name))
        else:
            out.append(f"[{k.idx}]")
    return tuple(out)


def _ref_spec_leaves(tree):
    import jax
    from jax.sharding import PartitionSpec

    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return [(_ref_path(p), tuple(s)) for p, s in flat]


def _port_spec_leaves(tree):
    from repro_torch.fl._tree import tree_leaves_with_path
    from repro_torch.launch.sharding import PartitionSpec

    return [(p, tuple(s)) for p, s in
            tree_leaves_with_path(tree, lambda x: isinstance(x, PartitionSpec))]


def _ref_struct_leaves(tree):
    import jax

    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(_ref_path(p), tuple(x.shape), np.dtype(x.dtype).name) for p, x in flat]


def _port_struct_leaves(tree):
    from repro_torch.fl._tree import tree_leaves_with_path

    return [(p, tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in tree_leaves_with_path(tree)]


def _no_repeated_axis(leaves):
    for path, spec in leaves:
        axes = [a for e in spec if e is not None for a in ((e,) if isinstance(e, str) else e)]
        assert len(axes) == len(set(axes)), (path, spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_equal_the_reference(arch):
    from repro.configs import INPUT_SHAPES as REF_SHAPES
    from repro.configs import get_model_config as ref_cfg
    from repro.launch import sharding as ref_sh
    from repro.launch import steps as ref_steps

    from repro_torch.configs import get_model_config, get_shape
    from repro_torch.launch import sharding as sh
    from repro_torch.launch import steps

    rcfg, cfg = ref_cfg(arch), get_model_config(arch)
    rps, ps = ref_steps.params_struct(rcfg), steps.params_struct(cfg)
    for mshape, axes in MESHES:
        mesh = _fake_mesh(mshape, axes)
        for mode in ("train", "decode"):
            for fo in (False, True):
                ref = _ref_spec_leaves(ref_sh.param_specs(rcfg, rps, mesh, mode,
                                                          fsdp_on_output=fo))
                got = _port_spec_leaves(sh.param_specs(cfg, ps, mesh, mode,
                                                       fsdp_on_output=fo))
                assert got == ref, (mshape, mode, fo)
                _no_repeated_axis(got)
        for rshape in REF_SHAPES:
            shape = get_shape(rshape.name)
            for seq_shard in (False, True):
                assert (sh.build_rules(cfg, mesh, shape, seq_shard=seq_shard)
                        == ref_sh.build_rules(rcfg, mesh, rshape, seq_shard=seq_shard))
    for rshape in REF_SHAPES:
        shape = get_shape(rshape.name)
        rstate = ref_steps.decode_state_struct(rcfg, rshape)
        state = steps.decode_state_struct(cfg, shape)
        for mshape, axes in MESHES:
            mesh = _fake_mesh(mshape, axes)
            ref = _ref_spec_leaves(ref_sh.decode_state_specs(rcfg, rstate, mesh, rshape))
            got = _port_spec_leaves(sh.decode_state_specs(cfg, state, mesh, shape))
            assert got == ref, (mshape, rshape.name)
            _no_repeated_axis(got)


@pytest.mark.parametrize("arch", ARCHS)
def test_stand_ins_equal_the_reference(arch):
    from repro.configs import INPUT_SHAPES as REF_SHAPES
    from repro.configs import get_model_config as ref_cfg
    from repro.launch import steps as ref_steps

    from repro_torch.configs import get_model_config, get_shape
    from repro_torch.launch import steps
    from repro_torch.fl._tree import tree_leaves_with_path

    rcfg, cfg = ref_cfg(arch), get_model_config(arch)
    ps = steps.params_struct(cfg)
    assert all(x.is_meta for _, x in tree_leaves_with_path(ps))
    assert _port_struct_leaves(ps) == _ref_struct_leaves(ref_steps.params_struct(rcfg))
    assert (_port_struct_leaves(steps.opt_struct(cfg, steps.make_optimizer()))
            == _ref_struct_leaves(ref_steps.opt_struct(rcfg, ref_steps.make_optimizer())))
    for rshape in REF_SHAPES:
        shape = get_shape(rshape.name)
        assert (_port_struct_leaves(steps.batch_specs(cfg, shape))
                == _ref_struct_leaves(ref_steps.batch_specs(rcfg, rshape)))
        inputs = steps.input_specs(cfg, shape)
        assert (_port_struct_leaves(inputs)
                == _ref_struct_leaves(ref_steps.input_specs(rcfg, rshape))), rshape.name
        assert all(x.is_meta for _, x in tree_leaves_with_path(inputs))


def test_model_flops_equal_the_reference():
    from repro.configs import INPUT_SHAPES
    from repro.launch import roofline as ref

    from repro_torch.launch import roofline

    for arch in ARCHS:
        for shape in INPUT_SHAPES:
            assert roofline.model_flops(arch, shape.name) == ref.model_flops(arch, shape.name)


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "reduce-scatter",
                                  "all-to-all", "collective-permute",
                                  "collective-broadcast"])
@pytest.mark.parametrize("g", [1, 2, 8, 16])
def test_collective_cost_is_the_reference_ring_model(kind, g):
    from repro.launch.hlo_cost import Computation, Op
    from repro.launch.hlo_cost import _collective_cost as ref_cost

    from repro_torch.launch.hlo_cost import _collective_cost

    n = 4096 * g
    in_n = {"all-gather": n // g}.get(kind, n)
    out_n = {"all-gather": n, "reduce-scatter": n // g}.get(kind, n)
    groups = "{{" + ",".join(str(i) for i in range(g)) + "}}"
    op = Op(name="c", type_str=f"f32[{out_n}]{{0}}", opcode=kind, operands=["a"],
            attrs=f", replica_groups={groups}")
    comp = Computation("x", shapes={"a": f"f32[{in_n}]{{0}}"})
    assert _collective_cost(kind, 4.0 * in_n, 4.0 * out_n, g) == ref_cost(op, comp)


def test_spec_placements_keep_mesh_order_and_refuse_repeats():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.models.sharding import spec_placements

    class Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (2, 4)[i]

    assert spec_placements(Mesh(), (None, ("data", "model"))) == [Shard(1), Shard(1)]
    assert spec_placements(Mesh(), ("model", None)) == [Replicate(), Shard(0)]
    with pytest.raises(ValueError, match="mesh order"):
        spec_placements(Mesh(), (("model", "data"),))
    with pytest.raises(ValueError, match="twice"):
        spec_placements(Mesh(), ("model", "model"))


def test_hints_are_no_ops_without_rules():
    from repro_torch.models.sharding import logical_to_spec, shard, use_logical_rules

    x = torch.ones(2, 3)
    assert shard(x, "batch", "embed") is x
    assert logical_to_spec("batch", None) == (None, None)
    with use_logical_rules(None, {"batch": "data"}):
        assert logical_to_spec("batch", None) == ("data", None)
        assert shard(x, "batch", "embed") is x          # a plain tensor
    assert logical_to_spec("batch") == (None,)


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------


def _rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def _loss_and_grads(cfg, params, batch):
    from repro_torch.fl._tree import tree_leaves, tree_unflatten
    from repro_torch.models import transformer as T

    live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, _ = T.loss_fn(tree_unflatten(params, live), cfg, batch, impl="blocked")
    return loss.detach(), torch.autograd.grad(loss, live, allow_unused=True,
                                              materialize_grads=True)


def _train_vs_plain(mesh, cfg, params, tok, b, s):
    """One train step's loss and gradients on ``mesh`` (train-mode layout:
    FSDP on "data") against the plain step: the loss's relative error, and
    each leaf's relative error beside its one-ulp nudge reading."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.fl._tree import tree_leaves, tree_leaves_with_path, tree_unflatten
    from repro_torch.launch.sharding import P, build_rules, distribute_params, param_specs
    from repro_torch.models.sharding import use_logical_rules

    shape = ShapeConfig("t", s, b, "train")
    rules = build_rules(cfg, mesh, shape)
    dp = distribute_params(params, mesh, param_specs(cfg, params, mesh, "train"))
    batch = {"tokens": tok[:, :s], "labels": tok[:, 1:s + 1]}
    l0, g0 = _loss_and_grads(cfg, params, batch)
    nudged = tree_unflatten(params, [t * (1 + 2.0 ** -23) for t in tree_leaves(params)])
    _, gn = _loss_and_grads(cfg, nudged, batch)
    with use_logical_rules(mesh, rules):
        bspec = {"tokens": P(rules["batch"], None), "labels": P(rules["batch"], None)}
        l1, g1 = _loss_and_grads(cfg, dp, distribute_params(batch, mesh, bspec))
    names = ["/".join(path) for path, _ in tree_leaves_with_path(params)]
    return {"loss": abs(float(_full(l1)) - float(l0)) / abs(float(l0)),
            "grads": {name: [_rel_err(_full(a), b_), _rel_err(n, b_)]
                      for name, a, b_, n in zip(names, g1, g0, gn)}}


def _tokens(cfg, b, s):
    return torch.randint(0, cfg.vocab_size, (b, s + 4),
                         generator=torch.Generator().manual_seed(1))


def _gloo_worker(rank, world, init, dims, out):
    """One rank of a 2-rank mesh: every GLOO_ARCHS smoke model's prefill,
    4 decode steps and one train step's loss and gradients, as DTensors and
    as plain tensors (RWKV6's also at batch 1 on the data mesh); the
    vmapped executor with and without the mesh."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import ShapeConfig, get_model_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (
        P,
        build_rules,
        decode_state_specs,
        distribute_params,
        param_specs,
    )
    from repro_torch.models import transformer as T
    from repro_torch.models.sharding import use_logical_rules

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    full = _full

    res = {}
    for arch in GLOO_ARCHS:
        cfg = get_model_config(arch, smoke=True)
        if cfg.moe is not None:           # the dry-run's groups: one per data rank
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_groups=dims[0]))
        b, s, cap = 4, 8, 16
        params = T.init_params(0, cfg, "cpu")
        tok = _tokens(cfg, b, s)
        r = {}
        # prefill + 4 decode steps (decode-mode layout: the cache on "model")
        shape = ShapeConfig("t", cap, b, "decode")
        rules = build_rules(cfg, mesh, shape)
        dp = distribute_params(params, mesh, param_specs(cfg, params, mesh, "decode"))
        want, st = T.prefill(params, cfg, tok[:, :s], max_len=cap, last_only=True)
        wants = [want[:, 0]]
        for i in range(4):
            lg, st = T.decode_step(params, cfg, st, tok[:, s + i])
            wants.append(lg)
        with use_logical_rules(mesh, rules):
            bt = P(rules["batch"], None)
            got, sd = T.prefill(dp, cfg, distribute_params(tok[:, :s], mesh, bt),
                                max_len=cap, last_only=True)
            sd = distribute_params(sd, mesh, decode_state_specs(cfg, sd, mesh, shape))
            gots = [got[:, 0]]
            for i in range(4):
                lg, sd = T.decode_step(dp, cfg, sd,
                                       distribute_params(tok[:, s + i], mesh, P(rules["batch"])))
                gots.append(lg)
        r["logits"] = [_rel_err(full(g), w) for g, w in zip(gots, wants)]
        r.update(_train_vs_plain(mesh, cfg, params, tok, b, s))
        res[arch] = r
        if arch == "rwkv6-3b" and dims[0] > 1:
            # a batch smaller than the data axis: the batch rule leaves it whole
            res["rwkv6-3b/batch1"] = _train_vs_plain(mesh, cfg, params, tok[:1], 1, s)
    res["vmapped"] = _vmapped_vs_plain(mesh)
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()


def _batch_worker(rank, world, init, dims, b, out):
    """One rank of a mesh whose ``data`` axis is longer than the batch:
    RWKV6's smoke train step at batch ``b`` against the plain step."""
    import torch.distributed as dist

    from repro_torch.configs import get_model_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    mesh = make_mesh(dims, ("data", "model"), "cpu")
    cfg = get_model_config("rwkv6-3b", smoke=True)
    params = T.init_params(0, cfg, "cpu")
    res = _train_vs_plain(mesh, cfg, params, _tokens(cfg, b, 8), b, 8)
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.destroy_process_group()


def _vmapped_vs_plain(mesh):
    """``VmappedExecutor(mesh=)`` against ``mesh=None``: 5 clients (an odd
    bucket: padded to 6 on a 2-rank data axis), stacked and shared inits."""
    from repro_torch.data import dirichlet_partition, make_classification_data
    from repro_torch.fl import MLPTask
    from repro_torch.fl.engine import ClientRequest, VmappedExecutor

    tr, _ = make_classification_data(n_samples=600, seed=0)
    idx = dirichlet_partition(tr.y, 7, 0.5, seed=0)
    task = MLPTask()
    gp = task.init(0, device="cpu")
    kw = dict(lr=0.1, batch_size=32, prox_mu=0.0)
    out = {}
    for init in ("shared", "stacked"):
        reqs = [ClientRequest(c, tr.x[idx[c]], tr.y[idx[c]], epochs=2, seed=c,
                              init_params=(None if init == "shared" else
                                           {k: v + 0.01 * c for k, v in gp.items()}))
                for c in range(5)]
        a = VmappedExecutor().run(task, gp, reqs, **kw)
        b = VmappedExecutor(mesh=mesh).run(task, gp, reqs, **kw)
        out[init] = {
            "ids": sorted(a.params) == sorted(b.params),
            "params": max(float((a.params[c][k] - b.params[c][k]).abs().max())
                          for c in a.params for k in a.params[c]),
            "losses": max(float(np.abs(a.losses[c] - b.losses[c]).max()) for c in a.losses),
        }
    return out


def _host_worker(out):
    """The reference's ``test_vmapped_executor_with_mesh_matches_sequential``
    on the port: a 1x1 host mesh (a one-rank gloo group), 3 clients, 2
    epochs; also against ``mesh=None``."""
    from repro_torch.data import dirichlet_partition, make_classification_data
    from repro_torch.fl import MLPTask
    from repro_torch.fl.engine import (
        ClientRequest,
        SequentialExecutor,
        VmappedExecutor,
    )
    from repro_torch.launch.mesh import make_host_mesh

    torch.set_num_threads(1)
    tr, _ = make_classification_data(n_samples=800, seed=0)
    idx = dirichlet_partition(tr.y, 10, 0.5, seed=0)
    task = MLPTask()
    gp = task.init(0, device="cpu")
    reqs = [ClientRequest(c, tr.x[idx[c]], tr.y[idx[c]], epochs=2, seed=c) for c in range(3)]
    kw = dict(lr=0.1, batch_size=32, prox_mu=0.0)
    seq = SequentialExecutor().run(task, gp, reqs, **kw)
    plain = VmappedExecutor().run(task, gp, reqs, **kw)
    par = VmappedExecutor(mesh=make_host_mesh("cpu")).run(task, gp, reqs, **kw)
    res = {"seq": [], "plain": 0.0}
    for c in seq.params:
        np.testing.assert_allclose(seq.losses[c], par.losses[c], atol=1e-5, rtol=1e-4)
        for k in seq.params[c]:
            np.testing.assert_allclose(seq.params[c][k].numpy(), par.params[c][k].numpy(),
                                       atol=1e-5, rtol=1e-4)
            res["plain"] = max(res["plain"],
                               float((plain.params[c][k] - par.params[c][k]).abs().max()))
    Path(out).write_text(json.dumps(res))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.fixture(scope="module")
def gloo_runs():
    """Both meshes' rank pairs, started together; mesh -> rank 0's results."""
    tmp = Path(tempfile.mkdtemp(prefix="gloo_mesh_"))
    procs, outs = [], {}
    for dims in GLOO_MESHES:
        tag = "x".join(map(str, dims))
        outs[dims] = tmp / f"{tag}.json"
        init = f"file://{tmp}/{tag}.rdzv"
        for rank in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, __file__, "gloo", str(rank), "2", init, tag,
                 str(outs[dims])], env=_env(), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    # batch 2 on a (4, 2) mesh: the smallest that met the RWKV6 fault
    outs["batch"] = tmp / "batch.json"
    for rank in range(8):
        procs.append(subprocess.Popen(
            [sys.executable, __file__, "batch", str(rank), "8", f"file://{tmp}/batch.rdzv",
             "4x2", "2", str(outs["batch"])], env=_env(), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs["host"] = tmp / "host.json"
    procs.append(subprocess.Popen([sys.executable, __file__, "host", str(outs["host"])],
                                  env=_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n".join(l[-3000:] for l in logs)
    return {dims: json.loads(path.read_text()) for dims, path in outs.items()}


def test_vmapped_executor_with_host_mesh_matches_sequential(gloo_runs):
    """The checks run in the job itself (the reference's tolerances); here,
    the host mesh also gives the ``mesh=None`` params exactly."""
    assert gloo_runs["host"]["plain"] == 0.0


@pytest.mark.parametrize("dims", GLOO_MESHES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_prefill_and_decode_match_plain(gloo_runs, arch, dims):
    errs = gloo_runs[dims][arch]["logits"]
    assert len(errs) == 5 and max(errs) < 1e-5, errs


def _grad_bound(arch, nudge):
    """1e-5 of each gradient leaf's scale, but for RWKV6's: its gradients
    are ill-conditioned, a one-ulp nudge (1 + 2^-23) of every weight moves
    them by up to 1.6e-4 of their scale (``nudge``), and tensor
    parallelism's split sums by up to 3.4e-5 (ROADMAP section 3).  There a
    leaf gets 4x its own nudge reading, at least 1e-5 and at most 1e-4, and
    the reading itself must stay that small."""
    if arch != "rwkv6-3b":
        return 1e-5
    assert nudge < 2.5e-4, nudge
    return min(1e-4, max(1e-5, 4 * nudge))


@pytest.mark.parametrize("dims", GLOO_MESHES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("arch", GLOO_ARCHS)
def test_sharded_train_step_matches_plain(gloo_runs, arch, dims):
    r = gloo_runs[dims][arch]
    assert r["loss"] < 1e-5, r["loss"]
    for leaf, (err, nudge) in r["grads"].items():
        assert err < _grad_bound(arch, nudge), (leaf, err, nudge)


@pytest.mark.parametrize("case", ["2x1-batch1", "4x2-batch2"])
def test_rwkv6_train_step_with_a_batch_below_the_data_axis_matches_plain(gloo_runs, case):
    """Batch 1 on the (2, 1) mesh and batch 2 on the (4, 2) one: on the
    latter, DTensor's backward of RWKV6's channel mix once sharded the
    flattened token dimension over ``data`` and could not unflatten it
    (``models.sharding.matmul`` keeps that gradient in the forward
    layout)."""
    r = (gloo_runs[(2, 1)]["rwkv6-3b/batch1"] if case == "2x1-batch1"
         else gloo_runs["batch"])
    assert r["loss"] < 1e-5, r["loss"]
    for leaf, (err, nudge) in r["grads"].items():
        assert err < _grad_bound("rwkv6-3b", nudge), (leaf, err, nudge)


@pytest.mark.parametrize("dims", GLOO_MESHES, ids=lambda d: "x".join(map(str, d)))
@pytest.mark.parametrize("init", ["shared", "stacked"])
def test_vmapped_executor_on_a_mesh_matches_no_mesh(gloo_runs, dims, init):
    r = gloo_runs[dims]["vmapped"][init]
    assert r["ids"]
    assert r["params"] <= 1e-6 and r["losses"] <= 1e-6, r


if __name__ == "__main__":
    if sys.argv[1] == "host":
        _host_worker(sys.argv[2])
    elif sys.argv[1] == "batch":
        _, _, rank, world, init, tag, b, out = sys.argv
        _batch_worker(int(rank), int(world), init, tuple(int(x) for x in tag.split("x")),
                      int(b), out)
    elif sys.argv[1] == "gloo":
        _, _, rank, world, init, tag, out = sys.argv
        _gloo_worker(int(rank), int(world), init,
                     tuple(int(x) for x in tag.split("x")), out)
