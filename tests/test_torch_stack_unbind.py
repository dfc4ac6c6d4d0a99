"""How a layer stack takes its layers' weights: one ``unbind`` of each
stacked leaf (``models/transformer.py::_unbind_layers``), not one select a
leaf and layer.  Port alone, bf16 smoke models on the CPU, under the vmapped
FL executor (``make_parallel_local_train``: one round of two SGD steps over
three clients), with ``cfg.remat`` on and off:

* the trained parameters equal, bit for bit, those of the select route,
  kept here as ``layer_params`` indexing the stacked leaves layer by layer;
* no ``select_backward`` and no ``add`` writes a tensor of a stacked leaf's
  shape (the select route's zero-filled buffer a layer, and their sum),
  which the select route does;
* every gradient that reaches the SGD update has contiguous client blocks
  (``kernels/sgd_update/kernel.py::_client_block_contiguous``, which the
  card's kernel needs).

On a 1x1 host mesh (in a subprocess: a process has one default group),
DTensor leaves unbind too and give the plain run's loss and gradients bit
for bit.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.configs import get_model_config
from repro_torch.fl import LMTask
from repro_torch.fl import client as fl_client
from repro_torch.fl.client import make_parallel_local_train
from repro_torch.kernels.sgd_update.kernel import _client_block_contiguous
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
# arch -> the smoke config's layers (OLMoE's cell runs one; DeepSeek's
# smoke model is one dense then two expert layers)
ARCHS = {"yi-6b": {}, "olmoe-1b-7b": {"n_layers": 1}, "deepseek-v2-lite": {},
         "hymba-1.5b": {}, "rwkv6-3b": {}}
# a batch and a length no stacked leaf's layer count or width equals, so
# that no activation takes a stacked leaf's shape
K, B, S, STEPS = 3, 3, 11, 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, remat=False, dtype="bfloat16"):
    return dataclasses.replace(get_model_config(arch, smoke=True), remat=remat,
                               dtype=dtype, **ARCHS[arch])


def _select_route(layers):
    """The select route: ``layer_params`` indexes the stacked leaves."""
    return layers


class _Writes(TorchDispatchMode):
    """Each op's name and its floating tensor outputs' shapes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        shapes = [tuple(t.shape) for t in tree_leaves(out)
                  if isinstance(t, torch.Tensor) and t.is_floating_point()]
        self.ops.append((func.overloadpacket.__name__, shapes))
        return out


def _round(cfg, monkeypatch, route=None):
    """One vmapped round of STEPS steps from a shared init: (the trained
    stacked params, the ops written, the gradients the update took)."""
    if route is not None:
        monkeypatch.setattr(T, "_unbind_layers", route)
    grads = []
    real = fl_client.sgd_update

    def watched(a, g, lr):
        grads.append(g)
        return real(a, g, lr)

    monkeypatch.setattr(fl_client, "sgd_update", watched)
    rng = np.random.default_rng(0)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (K, B * STEPS, S + 1)),
                          dtype=torch.int32)
    masks = torch.ones(K, B * STEPS)
    train = make_parallel_local_train(LMTask(cfg, seq_len=S), batch_size=B,
                                      n_batches=STEPS, epochs=1)
    p = T.init_params(0, cfg, "cpu")
    with _Writes() as mode:
        params, _ = train(p, tok[..., :-1], tok[..., 1:], masks, 0.1)
    monkeypatch.undo()
    return params, mode.ops, grads


def _stacked_shapes(cfg):
    """The physical shapes of the stacked leaves, (K, L, ...) under the
    client axis and (L, ...) of the shared init, less those a layer's own
    leaf also has (RWKV6's (2, d) pairs a layer against its (L, d) norms)."""
    p = T.init_params(0, cfg, "cpu")
    shapes = [tuple(v.shape) for k in ("layers", "dense_layers") if k in p
              for v in tree_leaves(p[k])]
    stacked = {s for v in shapes for s in (v, (K,) + v)}
    return stacked - {s for v in shapes for s in (v[1:], (K,) + v[1:])}


def _writes_at(ops, op, shapes):
    return [s for name, outs in ops if name == op for s in outs if s in shapes]


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off", "remat-on"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_unbound_layers_train_the_select_routes_bits(arch, remat, monkeypatch):
    cfg = _cfg(arch, remat)
    got, ops, grads = _round(cfg, monkeypatch)
    want, sel_ops, _ = _round(cfg, monkeypatch, route=_select_route)
    assert any(a.dtype == torch.bfloat16 for a in tree_leaves(got))
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    shapes = _stacked_shapes(cfg)
    assert _writes_at(sel_ops, "select_backward", shapes)          # the check can see
    assert not _writes_at(ops, "select_backward", shapes)
    assert not _writes_at(ops, "add", shapes)
    if max(cfg.n_layers - cfg.first_k_dense, cfg.first_k_dense) > 1:
        assert _writes_at(sel_ops, "add", shapes)
    assert len(grads) == STEPS * len(tree_leaves(got))
    assert all(_client_block_contiguous(g) for g in grads)


def _mesh_worker(out):
    """Yi's smoke model with its leaves as DTensors on a 1x1 host mesh (a
    one-rank gloo group), train-mode layout: one loss and gradient against
    the plain tensors'."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.sharding import P, build_rules, distribute_params, param_specs
    from repro_torch.models.sharding import use_logical_rules

    torch.set_num_threads(1)
    cfg = _cfg("yi-6b", dtype="float32")
    p = T.init_params(0, cfg, "cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, S + 1), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}

    def loss_and_grads(params, b):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = T.loss_fn(live, cfg, b, impl="naive")
        return loss, torch.autograd.grad(loss, tree_leaves(live))

    mesh = make_host_mesh("cpu")
    rules = build_rules(cfg, mesh, ShapeConfig("t", S, 2, "train"))
    dp = distribute_params(p, mesh, param_specs(cfg, p, mesh, "train"))
    with use_logical_rules(mesh, rules):
        bspec = {"tokens": P(rules["batch"], None), "labels": P(rules["batch"], None)}
        l1, g1 = loss_and_grads(dp, distribute_params(batch, mesh, bspec))
    l0, g0 = loss_and_grads(p, batch)
    Path(out).write_text(json.dumps({
        "dtensor_leaves": sum(type(v).__name__ == "DTensor" for v in tree_leaves(dp["layers"])),
        "loss_equal": bool(torch.equal(l1.full_tensor(), l0)),
        "grads_equal": all(torch.equal(a.full_tensor(), b) for a, b in zip(g1, g0)),
    }))


def test_dtensor_leaves_are_indexed_and_unchanged():
    """The mesh route unbinds DTensor leaves (the ``L`` axis is never
    sharded) and gives the plain tensors' loss and gradients."""
    out = Path(tempfile.mkdtemp(prefix="stack_mesh_")) / "mesh.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    run = subprocess.run([sys.executable, __file__, str(out)], env=env, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=300)
    assert run.returncode == 0, run.stdout[-3000:]
    r = json.loads(out.read_text())
    n = len(tree_leaves(T.init_params(0, _cfg("yi-6b", dtype="float32"), "cpu")["layers"]))
    assert r["dtensor_leaves"] == n
    assert r["loss_equal"] and r["grads_equal"]


if __name__ == "__main__":
    _mesh_worker(sys.argv[1])
