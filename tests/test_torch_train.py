"""LM training in the port (``make_train_step``, ``launch/train.py``, the
``blocked`` route, ``cfg.remat``) against the JAX reference, on the CPU.

The reference's weights and optimizer state are carried across with
``repro_torch.convert``, and both packages see the same numpy batches.
Tolerances:

* one train step (yi-6b, hymba and rwkv6 smoke configs, fp32): the loss
  within 1e-5, every gradient within 1e-5 of its leaf's largest magnitude
  (fp32 sums in another order through two layers).  The update is then fed
  the reference's gradients on both sides, since Adam divides by
  ``sqrt(nu)`` and turns 1e-7 of gradient noise on entries near 0 into
  moves of up to ``lr``: new params and moments within 1e-6 relative, with
  an absolute floor of 1e-6 of the leaf's largest magnitude;
* routes and remat in the port alone: ``blocked`` against ``naive`` within
  1e-5 (as above); remat on against off exactly equal (the same
  operations, recomputed);
* the vmapped FL round with ``remat=True`` against the sequential one,
  each checkpointing every layer of every grad step: the same cohort,
  params within 1e-5;
* ``lm_batches``: exactly equal ints.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.data import make_lm_stream as jax_lm_stream
from repro.launch import steps as JS
from repro.launch.train import lm_batches as jax_lm_batches
from repro.models import transformer as JT
from repro.optim import adamw as jax_adamw
from repro_torch import optim as P
from repro_torch.configs import get_model_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.data import FederatedData, SyntheticClassificationDataset, make_lm_stream
from repro_torch.fl import FLConfig, FLServer, LMTask, build_policy
from repro_torch.fl._tree import tree_leaves, tree_unflatten
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mamba.ops import selective_scan
from repro_torch.kernels.rwkv6.ops import wkv6, wkv6_heads
from repro_torch.launch import steps as S
from repro_torch.launch.train import lm_batches, train
from repro_torch.models import transformer as T

TOL = 1e-5
REL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """Each test here runs many small training steps. With the suite's
    workers sharing the cores, every intra-op thread team waits on
    descheduled threads, which slows such loops by an order of magnitude;
    one thread keeps them at their own cost (the tolerances hold at any
    thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaf_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _batch(vocab, b=2, s=32, seed=0):
    stream = jax_lm_stream(n_tokens=4000, vocab=vocab, seed=seed)
    return next(jax_lm_batches(stream, b, s, seed))


def _port_grads(params, cfg, batch, impl):
    live = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(params)]
    loss, _ = T.loss_fn(tree_unflatten(params, live), cfg, batch, impl=impl)
    return loss.detach(), torch.autograd.grad(loss, live)


def _strip(cfg):
    """``launch/train.py``'s frontend strip (whisper and InternVL2 train as
    decoders)."""
    if cfg.frontend is None:
        return cfg
    return dataclasses.replace(cfg, frontend=None, enc_dec=False, n_enc_layers=0, enc_seq=0)


@pytest.mark.parametrize("arch", ["yi-6b", "hymba-1.5b", "rwkv6-3b", "whisper-medium"])
def test_train_step_equals_the_reference(arch):
    """whisper-medium, stripped as ``train()`` strips it, is a decoder
    without RoPE: its forward adds the reference's sinusoidal positions."""
    jcfg = _strip(jax_config(arch, smoke=True))
    tcfg = _strip(get_model_config(arch, smoke=True))
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    jopt = jax_adamw(1e-3, weight_decay=0.1, grad_clip=1.0)
    value_and_grad = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, jcfg, b, impl="blocked"), has_aux=True))
    # one reference step first, so the state carries moments and step 1
    _, g1 = value_and_grad(jp, _batch(jcfg.vocab_size))
    jp, js = jopt.update(g1, jp, jopt.init(jp))
    jbatch = _batch(jcfg.vocab_size, seed=1)
    (jloss, jmetrics), jgrads = value_and_grad(jp, jbatch)
    want_p, want_s = jopt.update(jgrads, jp, js)

    tp = params_from_numpy(_np(jp), "cpu")
    ts = {"mu": params_from_numpy(_np(js["mu"]), "cpu"),
          "nu": params_from_numpy(_np(js["nu"]), "cpu"),
          "step": torch.as_tensor(np.array(js["step"]))}
    tbatch = {k: torch.as_tensor(np.asarray(v)) for k, v in jbatch.items()}
    ref_grads = params_from_numpy(_np(jgrads), "cpu")
    topt = P.adamw(1e-3, weight_decay=0.1, grad_clip=1.0)
    seen = []

    def update(grads, params, state):         # record the port's gradients,
        seen.append(grads)                     # step with the reference's
        return topt.update(ref_grads, params, state)

    snap = [t.clone() for t in tree_leaves((tp, ts))]
    new_p, new_s, metrics = S.make_train_step(tcfg, P.Optimizer(topt.init, update))(
        tp, ts, tbatch)
    assert all(torch.equal(a, b) for a, b in zip(snap, tree_leaves((tp, ts))))
    assert sorted(metrics) == ["aux", "loss", "xent"]
    assert all(not m.requires_grad and m.shape == () for m in metrics.values())
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(metrics["xent"]), float(jmetrics["xent"]), rtol=TOL,
                               atol=TOL)
    for i, (got, want) in enumerate(zip(tree_leaves(params_to_numpy(seen[0])),
                                        jax.tree.leaves(_np(jgrads)))):
        _leaf_close(got, want, TOL, ("grad", i))
    for got, want in zip(tree_leaves(params_to_numpy(new_p)), jax.tree.leaves(_np(want_p))):
        np.testing.assert_allclose(got, want, rtol=REL, atol=REL * np.abs(want).max())
    for key in ("mu", "nu"):
        for got, want in zip(tree_leaves(params_to_numpy(new_s[key])),
                             jax.tree.leaves(_np(want_s[key]))):
            np.testing.assert_allclose(got, want, rtol=REL, atol=REL * np.abs(want).max())
    assert int(new_s["step"]) == int(want_s["step"]) == 2


def test_make_optimizer_equals_the_reference():
    jopt, topt = JS.make_optimizer(2000), S.make_optimizer(2000)
    params = {"w": np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4)}
    jp, tp = jax.tree.map(jnp.asarray, params), params_from_numpy(params, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        g = {"w": np.full((3, 4), 0.5 * (i + 1), np.float32)}
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), jp, js)
        tp, ts = topt.update(params_from_numpy(g, "cpu"), tp, ts)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=REL)


@pytest.mark.parametrize("arch", ["yi-6b", "h2o-danube-3-4b", "hymba-1.5b"])
def test_blocked_and_naive_routes_agree(arch):
    cfg = get_model_config(arch, smoke=True)
    params = T.init_params(0, cfg, "cpu")
    batch = {k: torch.as_tensor(np.asarray(v))
             for k, v in _batch(cfg.vocab_size, s=96).items()}   # past the window of 64
    lb, gb = _port_grads(params, cfg, batch, "blocked")
    ln, gn = _port_grads(params, cfg, batch, "naive")
    np.testing.assert_allclose(float(lb), float(ln), rtol=TOL, atol=TOL)
    for a, b in zip(gb, gn):
        _leaf_close(a.numpy(), b.numpy(), TOL, arch)


@pytest.mark.parametrize("arch", ["yi-6b", "hymba-1.5b", "rwkv6-3b"])
def test_remat_checkpoints_each_layer_and_changes_nothing(arch, monkeypatch):
    cfg = get_model_config(arch, smoke=True)
    assert not cfg.remat
    params = T.init_params(0, cfg, "cpu")
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in _batch(cfg.vocab_size).items()}
    calls = []
    real = T.checkpoint
    monkeypatch.setattr(T, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    l0, g0 = _port_grads(params, cfg, batch, "blocked")
    assert calls == []
    l1, g1 = _port_grads(params, dataclasses.replace(cfg, remat=True), batch, "blocked")
    assert len(calls) == cfg.n_layers
    assert torch.equal(l0, l1) and all(torch.equal(a, b) for a, b in zip(g0, g1))
    with torch.no_grad():                     # nothing to recompute for
        T.forward(params, dataclasses.replace(cfg, remat=True), batch["tokens"])
    assert len(calls) == cfg.n_layers


def _lm_fl_server(cfg, executor):
    seq, n_dev = 16, 6
    stream = make_lm_stream(n_tokens=60 * (seq + 1), vocab=cfg.vocab_size, seed=0)
    cut = stream[:60 * (seq + 1)].reshape(60, seq + 1)
    x, y = cut[:, :-1], cut[:, 1:]
    data = FederatedData(SyntheticClassificationDataset(x[:48], y[:48], cfg.vocab_size),
                         SyntheticClassificationDataset(x[48:], y[48:], cfg.vocab_size),
                         [np.arange(i, 48, n_dev) for i in range(n_dev)])
    fl = FLConfig(n_devices=n_dev, k_select=2, rounds=1, l_ep=1, lr=0.3, seed=0,
                  executor=executor)
    return FLServer(fl, LMTask(cfg, seq_len=seq), data, device="cpu")


def test_vmapped_lm_round_with_remat_equals_the_sequential_one(monkeypatch):
    """Both executors rematerialise: the sequential one's
    ``torch.autograd.grad`` through ``torch.utils.checkpoint``, the vmapped
    one's ``vmap(grad(...))`` through the layer checkpoint that composes with
    ``torch.func``; each applies its checkpoint once a layer per grad step
    (one stack a step)."""
    cfg = dataclasses.replace(get_model_config("yi-6b", smoke=True), remat=True)
    calls, routes = [], []
    real, real_remat = T.checkpoint, T._remat
    monkeypatch.setattr(T, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(T, "_remat", lambda *a: routes.append(real_remat(*a)) or routes[-1])
    runs, init = {}, None
    for executor in ("sequential", "vmapped"):
        srv = _lm_fl_server(cfg, executor)
        if init is None:
            init = srv.global_params
        srv.global_params = init
        routes.clear()
        n0, applied = len(calls), T._checkpoint_layer.applied
        res = srv.run_round(build_policy("fedavg"))
        runs[executor] = (res, srv.global_params, len(calls) - n0,
                          T._checkpoint_layer.applied - applied,
                          routes.count("autograd"), routes.count("func"))
    (rs, ps, ns, fs, ss, _), (rv, pv, nv, fv, sv, steps) = runs["sequential"], runs["vmapped"]
    assert ss > 0 and ns == cfg.n_layers * ss and fs == 0
    assert steps > 0 and fv == cfg.n_layers * steps and nv == sv == 0
    np.testing.assert_array_equal(rs.selected, rv.selected)
    assert np.isfinite(rv.test_loss)
    for a, b in zip(tree_leaves(ps), tree_leaves(pv)):
        torch.testing.assert_close(b, a, rtol=TOL, atol=TOL)


def test_lm_batches_equal_the_reference():
    stream = make_lm_stream(n_tokens=5000, vocab=256, seed=3)
    mine, ref = lm_batches(stream, 4, 64, seed=3, device="cpu"), jax_lm_batches(stream, 4, 64, 3)
    for _ in range(5):
        got, want = next(mine), next(ref)
        for key in ("tokens", "labels"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("arch,lr", [("yi-6b", 3e-3), ("rwkv6-3b", 5e-3)])
def test_train_driver_reduces_loss(arch, lr, tmp_path):
    """200 steps of the driver (``impl="naive"``): the mean of the last ten
    losses is below the mean of the first ten (each batch's loss is noisy
    to a few 1e-2 on this stream); the checkpoint holds the final state."""
    from repro_torch.checkpoint import load_pytree

    path = str(tmp_path / "step_200.ckpt")
    hist = train(arch, smoke=True, steps=200, batch=8, seq=64, lr=lr, log_every=1,
                 ckpt=path, verbose=False, device="cpu")
    loss = np.asarray(hist["loss"])
    assert np.isfinite(loss).all() and len(loss) == 200
    assert loss[-10:].mean() < loss[:10].mean()
    back = load_pytree(path)
    assert sorted(back) == ["opt", "params"] and int(back["opt"]["step"]) == 200


# ---------------------------------------------------------------------------
# the kernels' ops have no backward: they refuse inputs that require grad
# ---------------------------------------------------------------------------


def _op_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    return {
        "flash_attention": (flash_attention, (r(1, 8, 4, 16), r(1, 8, 2, 16), r(1, 8, 2, 16))),
        "selective_scan": (selective_scan, (r(1, 5, 8), r(1, 5, 8).abs(), r(1, 5, 4),
                                            r(1, 5, 4), -r(8, 4).abs(), r(1, 8, 4))),
        "wkv6_heads": (wkv6_heads, (r(1, 5, 2, 4), r(1, 5, 2, 4), r(1, 5, 2, 4),
                                    -r(1, 5, 2, 4).abs(), r(2, 4), r(1, 2, 4, 4))),
        "wkv6": (wkv6, (r(2, 5, 4), r(2, 5, 4), r(2, 5, 4), -r(2, 5, 4).abs(), r(2, 4),
                        r(2, 4, 4))),
    }


@pytest.mark.parametrize("name", ["flash_attention", "selective_scan", "wkv6_heads", "wkv6"])
def test_kernel_ops_refuse_inputs_that_require_grad(name):
    op, args = _op_inputs()[name]
    want = op(*args)
    for i in range(len(args)):
        live = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(ValueError, match="impl='naive' or impl='blocked'"):
            op(*live)
        with torch.no_grad():
            got = op(*live)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["yi-6b", "hymba-1.5b", "rwkv6-3b"])
def test_training_through_the_kernel_route_raises(arch):
    cfg = get_model_config(arch, smoke=True)
    params = T.init_params(0, cfg, "cpu")
    batch = {k: torch.as_tensor(np.asarray(v)) for k, v in _batch(cfg.vocab_size).items()}
    step = S.make_train_step(cfg, P.adamw(1e-3), impl="flash")
    with pytest.raises(ValueError, match="has no backward"):
        step(params, P.adamw(1e-3).init(params), batch)
    with torch.no_grad():                     # serving through the ops is unaffected
        T.forward(params, cfg, batch["tokens"], impl="flash")
