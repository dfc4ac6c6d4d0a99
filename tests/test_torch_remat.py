"""``cfg.remat`` under ``torch.func`` transforms: the vmapped FL executor's
``vmap(grad_and_value(loss))`` checkpoints each layer through
``_LayerCheckpoint``, as the reference's ``jax.checkpoint`` does under
``jax.vmap``.  Port alone, fp32 on the CPU, smoke configs of every family
``_run_stack`` serves (dense, sliding-window, MoE, RWKV6, Hymba's attention
+ Mamba, whisper's encoder and decoder, the VLM):

* remat on against off: the same losses and gradients bit for bit (the
  same operations, the layer recomputed from its saved inputs), except
  whisper's encoder leaves: the encoder output's cotangent is summed
  layer by layer (as the reference's ``lax.scan`` transpose sums it), not
  use by use, so those lie within 1e-6 of each leaf's largest magnitude
  (fp32 sums in another association);
* each stack applies the checkpoint once a layer per grad step, and each
  layer body runs twice (forward, then the recompute in the backward);
  without remat once;
* with grad off (``vmap`` of the accuracy) nothing is checkpointed or
  recomputed;
* a second derivative (``grad`` of a gradient's projection) through the
  checkpoint equals remat off's within 1e-5 of each leaf's largest
  magnitude: the backward runs below its own grad level, where the
  enclosing transform still records it;
* no layer runs plain without saying so: forward-mode AD, which the
  checkpoint has no rule for, raises and names the reason.

The vmapped LM FL round with remat is held to the reference in
``test_torch_lm_fl.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_model_config
from repro_torch.fl import LMTask
from repro_torch.models import transformer as T

ARCHS = ("yi-6b", "h2o-danube-3-4b", "olmoe-1b-7b", "rwkv6-3b", "hymba-1.5b",
         "whisper-medium", "internvl2-76b")
K, B, S = 3, 2, 8
ENC_TOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """Small steps: one intra-op thread keeps them at their own cost when
    the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(arch, seed=0):
    """K clients' batches and one shared init (expanded over K, as the
    vmapped executor broadcasts the global params)."""
    cfg = get_model_config(arch, smoke=True)
    rng = np.random.default_rng(seed)
    tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (K, B, S + 1)), dtype=torch.int32)
    batch = {"tokens": tok[..., :-1], "labels": tok[..., 1:],
             "loss_mask": torch.as_tensor(rng.random((K, B, S)) < 0.8, dtype=torch.float32)}
    if cfg.frontend is not None:
        n = cfg.enc_seq if cfg.enc_dec else cfg.frontend.n_tokens
        batch["frontend_embeds"] = torch.as_tensor(
            rng.standard_normal((K, B, n, cfg.frontend.embed_dim)), dtype=torch.float32)
    p = torch.utils._pytree.tree_map(lambda a: a.unsqueeze(0).expand((K,) + a.shape),
                                     T.init_params(seed, cfg, "cpu"))
    return cfg, p, batch


def _n_layers(cfg):
    return cfg.n_layers + (cfg.n_enc_layers if cfg.enc_dec else 0)


def _counting_layers(monkeypatch):
    """Count every run of a layer body."""
    runs = []
    real = T._seq_layer

    def counted(*a, **kw):
        runs.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(T, "_seq_layer", counted)
    return runs


def _vmapped_grads(cfg, p, batch):
    def loss(params, b):
        return T.loss_fn(params, cfg, b)[0]

    return torch.func.vmap(torch.func.grad_and_value(loss))(p, batch)


@pytest.mark.parametrize("arch", ARCHS)
def test_vmapped_grad_with_remat_equals_without(arch, monkeypatch):
    cfg, p, batch = _inputs(arch)
    runs = _counting_layers(monkeypatch)
    out = {}
    for remat in (False, True):
        runs.clear()
        applied = T._checkpoint_layer.applied
        grads, loss = _vmapped_grads(dataclasses.replace(cfg, remat=remat), p, batch)
        out[remat] = (loss, torch.utils._pytree.tree_flatten_with_path(grads)[0],
                      T._checkpoint_layer.applied - applied, len(runs))
    n = _n_layers(cfg)
    assert out[False][2:] == (0, n)               # plain: no checkpoint, one run a layer
    assert out[True][2:] == (n, 2 * n)            # a checkpoint a layer, run twice
    assert out[True][0].shape == (K,) and bool(torch.isfinite(out[True][0]).all())
    assert torch.equal(out[True][0], out[False][0])
    assert len(out[True][1]) == len(out[False][1])
    for (path, a), (_, b) in zip(out[True][1], out[False][1]):
        if path[0].key == "encoder":
            assert float((a - b).abs().max()) <= ENC_TOL * float(b.abs().max()), path
        else:
            assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ["yi-6b", "whisper-medium"])
def test_second_derivative_through_remat(arch):
    """The checkpoint's backward runs below its own grad level, so an
    enclosing ``torch.func.grad`` still differentiates it: the derivative of
    a gradient's projection equals remat off's within 1e-5 of each leaf's
    largest magnitude (fp32 sums in another order)."""
    cfg, p, batch = _inputs(arch)
    params = torch.utils._pytree.tree_map(lambda a: a[0], p)
    one = {k: v[0] for k, v in batch.items()}
    proj = torch.utils._pytree.tree_map(torch.ones_like, params)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)

        def projected(q):
            # a squared-logit objective: the cross-entropy's backward works
            # in place and has no second derivative
            g = torch.func.grad(lambda r: T.forward(r, c, one["tokens"],
                                                    one.get("frontend_embeds"))[0].square().mean())(q)
            return sum((a * b).sum() for a, b in zip(torch.utils._pytree.tree_leaves(g),
                                                     torch.utils._pytree.tree_leaves(proj)))

        out[remat] = torch.utils._pytree.tree_leaves(torch.func.grad(projected)(params))
    for a, b in zip(out[True], out[False]):
        assert float((a - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max()))


def test_remat_with_grad_off_recomputes_nothing(monkeypatch):
    """The accuracy path under ``vmap`` with grad off: no checkpoint, one
    run a layer, the accuracy of remat off."""
    cfg, p, batch = _inputs("yi-6b")
    runs = _counting_layers(monkeypatch)
    task_b = {"x": batch["tokens"], "y": batch["labels"], "mask": batch["loss_mask"][..., 0]}
    acc = {}
    for remat in (False, True):
        task = LMTask(dataclasses.replace(cfg, remat=remat), seq_len=S)
        runs.clear()
        applied = T._checkpoint_layer.applied
        with torch.no_grad():
            acc[remat] = torch.func.vmap(task.accuracy)(p, task_b)
        assert (T._checkpoint_layer.applied - applied, len(runs)) == (0, cfg.n_layers)
    assert torch.equal(acc[True], acc[False])


def test_remat_under_forward_mode_raises():
    """No layer runs plain under a transform with ``cfg.remat``: forward-mode
    AD, which the checkpoint has no rule for, raises and names the reason;
    with remat off it runs."""
    cfg, p, batch = _inputs("yi-6b")
    one = {k: v[0] for k, v in batch.items()}
    params = torch.utils._pytree.tree_map(lambda a: a[0], p)
    x = T.embed_tokens(params, cfg, one["tokens"])

    def stack(h, remat):
        c = dataclasses.replace(cfg, remat=remat)
        return T._run_stack(c, "naive", True, h, params["layers"], c.n_layers)[0]

    tangent = torch.ones_like(x)
    _, t_plain = torch.func.jvp(lambda h: stack(h, False), (x,), (tangent,))
    assert bool(torch.isfinite(t_plain).all())
    with pytest.raises(NotImplementedError, match="forward-mode AD.*cfg.remat=False"):
        torch.func.jvp(lambda h: stack(h, True), (x,), (tangent,))


def test_remat_route_by_caller(monkeypatch):
    """Plain autograd keeps ``torch.utils.checkpoint``; a ``torch.func``
    transform takes the layer checkpoint; grad off or ``cfg.remat`` off
    runs plain."""
    cfg, p, batch = _inputs("yi-6b")
    params = torch.utils._pytree.tree_map(lambda a: a[0].clone(), p)
    x = torch.zeros(B, S, cfg.d_model)
    on, off = dataclasses.replace(cfg, remat=True), cfg
    assert T._remat(on, x, params["layers"]) == "autograd"
    assert T._remat(off, x, params["layers"]) is None
    with torch.no_grad():
        assert T._remat(on, x, params["layers"]) is None
    seen = []
    torch.func.grad(lambda h: seen.append(T._remat(on, h, params["layers"])) or h.sum())(x)
    torch.func.vmap(lambda h: seen.append(T._remat(on, h, params["layers"])) or h)(x)
    assert seen == ["func", "func"]
