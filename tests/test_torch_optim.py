"""The port's optimizers and schedules (``repro_torch.optim``) against the
JAX reference (``repro.optim``), on the CPU.

Inputs are numpy arrays drawn from a seed, given to both.  Tolerances:

* schedules: within 1 fp32 ulp (the same fp32 expressions; ``cos`` and the
  divisions may round differently by one ulp);
* ``global_norm``: within 1e-6 relative (fp32 sums in another order);
  clipped leaves within 1e-6 relative in fp32 and 1 bf16 ulp in bf16 (one
  rounding of a product that may differ in the last fp32 bit);
* AdamW and SGD, 5 updates fed the same gradient sequence: params and
  moments within 1e-6 relative (elementwise, with an absolute floor of
  1e-6 of the leaf's largest magnitude for entries near 0), bf16 params
  within 1 bf16 ulp, ``step`` exactly equal.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as P
from repro_torch.convert import params_from_numpy, params_to_numpy

REL = 1e-6


def _tree(seed, dtype=np.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    t = {"b": rng.normal(size=(5,)) * scale,
         "a": {"w": rng.normal(size=(3, 4)) * scale, "z": rng.normal(size=(2, 3, 2)) * scale},
         "c": rng.normal(size=()) * scale}
    return jax.tree.map(lambda x: np.asarray(x, np.float32).astype(dtype), t)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close(got, want, what=""):
    """fp32 leaves within REL relative; bf16 leaves within one bf16 ulp."""
    for g, w in zip(_np_leaves(got), _np_leaves(want)):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        if w.dtype == ml_dtypes.bfloat16:
            gb, wb = g.view(np.int16).astype(np.int32), w.view(np.int16).astype(np.int32)
            assert np.abs(gb - wb).max(initial=0) <= 1, (what, g, w)
        else:
            floor = REL * float(np.abs(w).max(initial=0))
            np.testing.assert_allclose(g, w, rtol=REL, atol=floor, err_msg=what)


@pytest.mark.parametrize("step", [0, 1, 10, 11, 100, 107])
def test_schedules_equal_the_reference(step):
    pairs = [(J.constant_schedule(3e-4), P.constant_schedule(3e-4)),
             (J.cosine_schedule(3e-4, 100), P.cosine_schedule(3e-4, 100)),
             (J.cosine_schedule(1.0, 90, final_frac=0.0), P.cosine_schedule(1.0, 90, 0.0)),
             (J.linear_warmup_cosine(3e-4, 10, 100), P.linear_warmup_cosine(3e-4, 10, 100)),
             (J.linear_warmup_cosine(3e-3, 0, 40), P.linear_warmup_cosine(3e-3, 0, 40))]
    for jf, pf in pairs:
        want = np.asarray(jf(jnp.asarray(step, jnp.int32)))
        got = pf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_global_norm_and_clip_equal_the_reference(dtype, max_norm):
    tree = _tree(0, dtype, scale=3.0)
    jn = J.global_norm(_jax(tree))
    tn = P.global_norm(params_from_numpy(tree, "cpu"))
    assert tn.dtype == torch.float32
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=REL)
    jc, jnorm = J.clip_by_global_norm(_jax(tree), max_norm)
    tc, tnorm = P.clip_by_global_norm(params_from_numpy(tree, "cpu"), max_norm)
    np.testing.assert_allclose(tnorm.numpy(), np.asarray(jnorm), rtol=REL)
    _close(params_to_numpy(tc), jax.tree.map(np.asarray, jc), "clipped")


def _run_both(jopt, topt, params, grads_seq):
    jp = _jax(params)
    js = jopt.init(jp)
    tp = params_from_numpy(params, "cpu")
    ts = topt.init(tp)
    for g in grads_seq:
        jp, js = jopt.update(_jax(g), jp, js)
        tp, ts = topt.update(params_from_numpy(g, "cpu"), tp, ts)
    return jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js), tp, ts


def _grads(n, dtype=np.float32):
    return [_tree(100 + i, dtype, scale=0.5) for i in range(n)]


@pytest.mark.parametrize("weight_decay,grad_clip,dtype", [
    (0.0, None, np.float32), (0.1, None, np.float32), (0.0, 1.0, np.float32),
    (0.01, 1.0, np.float32), (0.1, None, ml_dtypes.bfloat16),
    (0.01, 1.0, ml_dtypes.bfloat16)])
def test_adamw_equals_the_reference(weight_decay, grad_clip, dtype):
    params = _tree(1, dtype)
    kw = dict(weight_decay=weight_decay, grad_clip=grad_clip)
    jp, js, tp, ts = _run_both(J.adamw(J.linear_warmup_cosine(1e-2, 2, 10), **kw),
                                  P.adamw(P.linear_warmup_cosine(1e-2, 2, 10), **kw),
                                  params, _grads(5, dtype))
    _close(params_to_numpy(tp), jp, "params")
    for key in ("mu", "nu"):
        assert all(t.dtype == torch.float32 for t in jax.tree.leaves(ts[key]))
        _close(params_to_numpy(ts[key]), js[key], key)
    assert sorted(ts) == sorted(js) == ["mu", "nu", "step"]
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    assert int(ts["step"]) == int(js["step"]) == 5


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False), (0.9, True)])
@pytest.mark.parametrize("grad_clip", [None, 1.0])
def test_sgd_equals_the_reference(momentum, nesterov, grad_clip):
    params = _tree(2)
    kw = dict(momentum=momentum, nesterov=nesterov, grad_clip=grad_clip)
    jp, js, tp, ts = _run_both(J.sgd(0.05, **kw), P.sgd(0.05, **kw), params, _grads(5))
    _close(params_to_numpy(tp), jp, "params")
    assert sorted(ts) == sorted(js)
    if momentum:
        _close(params_to_numpy(ts["mom"]), js["mom"], "mom")
    assert int(ts["step"]) == int(js["step"]) == 5


def test_update_leaves_its_inputs_alone():
    params = params_from_numpy(_tree(3), "cpu")
    grads = params_from_numpy(_tree(4), "cpu")
    opt = P.adamw(0.1, weight_decay=0.1)
    state = opt.init(params)
    snap = [t.clone() for t in jax.tree.leaves((params, grads, state))]
    new_p, new_s = opt.update(grads, params, state)
    assert all(torch.equal(a, b) for a, b in zip(snap, jax.tree.leaves((params, grads, state))))
    assert not torch.equal(new_p["b"], params["b"])


# mirrors of tests/test_infra.py


def _quad_min(opt, steps=300):
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = opt.init(params)

    def loss(p):
        return torch.sum(torch.square(p["w"] - target))

    for _ in range(steps):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss({"w": w}), [w])
        params, state = opt.update({"w": g}, params, state)
    return float(loss(params))


def test_adamw_converges_quadratic():
    assert _quad_min(P.adamw(0.05, weight_decay=0.0)) < 1e-3


def test_sgd_momentum_converges_quadratic():
    assert _quad_min(P.sgd(0.05, momentum=0.9)) < 1e-3


def test_grad_clip():
    tree = {"a": torch.full((10,), 100.0)}
    clipped, norm = P.clip_by_global_norm(tree, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(10 * 100.0 ** 2))
    cn = float(torch.sqrt(torch.sum(torch.square(clipped["a"]))))
    assert cn == pytest.approx(1.0, rel=1e-5)


def test_schedules_shapes():
    s = P.linear_warmup_cosine(1.0, 10, 100)
    assert float(s(torch.tensor(0))) <= 0.1
    assert float(s(torch.tensor(10))) == pytest.approx(1.0)
    assert float(s(torch.tensor(100))) < 0.5
    c = P.cosine_schedule(1.0, 100)
    assert float(c(torch.tensor(100))) == pytest.approx(0.1, abs=1e-6)


def test_adamw_bf16_params_fp32_master():
    opt = P.adamw(0.01)
    params = {"w": torch.ones((4,), dtype=torch.bfloat16)}
    st = opt.init(params)
    assert st["mu"]["w"].dtype == torch.float32
    p2, st2 = opt.update({"w": torch.ones((4,), dtype=torch.bfloat16)}, params, st)
    assert p2["w"].dtype == torch.bfloat16
