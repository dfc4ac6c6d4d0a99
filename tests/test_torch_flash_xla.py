"""The port's blocked attention with its chunked backward
(``repro_torch.models.flash_xla``), the ``blocked`` attention route and the
memory-lean cross-entropy against the JAX reference, on the CPU.

Inputs are numpy arrays drawn from a seed, given to both.  Tolerances:

* fp32 forward: within 1e-5 (fp32 sums over the chunks in another order);
* fp32 gradients (dq, dk, dv; the layer's and the loss's): within 1e-5 of
  each tensor's largest magnitude, against ``jax.vjp`` of the reference and
  against autograd of the port's ``naive_attention``;
* bf16 inputs: outputs and gradients within one bf16 ulp at the tensor's
  largest magnitude, 2^(floor(log2 max|x|) - 7).  Each is rounded to bf16
  once from fp32 values that agree to ~1e-6, but the backward reads the
  bf16 output: where the two sides round an output entry to neighbouring
  bf16 values, ``rowsum(dO * O)`` moves by a bf16 ulp of that entry, and
  every gradient of its row with it.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.flash_xla import flash_attention_xla as jax_flash_xla
from repro_torch.configs import get_model_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.flash_xla import flash_attention_xla

TOL = 1e-5


def _inputs(b, s, kv, g, dh, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, kv, g, dh)).astype(np.float32).astype(dtype)
    k = rng.normal(size=(b, s, kv, dh)).astype(np.float32).astype(dtype)
    v = rng.normal(size=(b, s, kv, dh)).astype(np.float32).astype(dtype)
    do = rng.normal(size=(b, s, kv, g, dh)).astype(np.float32).astype(dtype)
    return q, k, v, do


def _t(x):
    return params_from_numpy({"x": x}, "cpu")["x"]


def _np(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _close_scaled(got, want, what):
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= TOL * scale, (what, err, scale)


def _within_a_bf16_ulp(got, want):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    return float(np.abs(g - w).max()) <= ulp


def _port(q, k, v, do, causal, window, qc, kc):
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    out = flash_attention_xla(tq, tk, tv, causal, window, qc, kc)
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    return _np(out), [_np(gr) for gr in grads]


def _ref(q, k, v, do, causal, window, qc, kc):
    out, vjp = jax.vjp(lambda a, b_, c: jax_flash_xla(a, b_, c, causal, window, qc, kc),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(gr) for gr in vjp(jnp.asarray(do))]


CASES = [  # (b, s, kv, g, dh, causal, window, q_chunk, kv_chunk)
    (2, 64, 2, 1, 16, True, None, 16, 32),
    (2, 64, 2, 4, 16, True, None, 16, 32),
    (1, 64, 2, 4, 16, False, None, 16, 32),
    (2, 64, 1, 4, 8, True, 20, 16, 32),
    (1, 64, 2, 1, 8, False, 24, 16, 32),
    (2, 40, 2, 4, 16, True, None, 16, 32),     # ragged: both chunks become S
    (1, 48, 2, 4, 16, True, 10, 16, 32),       # q chunks of 16, one kv chunk of S
    (1, 32, 1, 4, 8, True, None, 512, 1024),   # the defaults, degenerate
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_forward_and_gradients_equal_the_reference(case):
    b, s, kv, g, dh, causal, window, qc, kc = case
    q, k, v, do = _inputs(b, s, kv, g, dh, seed=s + g)
    out, grads = _port(q, k, v, do, causal, window, qc, kc)
    want_out, want_grads = _ref(q, k, v, do, causal, window, qc, kc)
    np.testing.assert_allclose(out, want_out, atol=TOL, rtol=0)
    for name, got, want in zip("qkv", grads, want_grads):
        _close_scaled(got, want, "d" + name)


@pytest.mark.parametrize("case", CASES[:6], ids=str)
def test_gradients_equal_autograd_of_naive_attention(case):
    b, s, kv, g, dh, causal, window, qc, kc = case
    q, k, v, do = _inputs(b, s, kv, g, dh, seed=7)
    out, grads = _port(q, k, v, do, causal, window, qc, kc)
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    naive = A.naive_attention(tq.reshape(b, s, kv * g, dh), tk, tv, causal=causal,
                              window=window).reshape(b, s, kv, g, dh)
    want = torch.autograd.grad(naive, (tq, tk, tv), _t(do))
    np.testing.assert_allclose(out, naive.detach().numpy(), atol=TOL, rtol=0)
    for name, got, w in zip("qkv", grads, want):
        _close_scaled(got, w.numpy(), "d" + name)


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[5]], ids=str)
def test_bf16_inputs_equal_the_reference(case):
    b, s, kv, g, dh, causal, window, qc, kc = case
    q, k, v, do = _inputs(b, s, kv, g, dh, seed=3, dtype=ml_dtypes.bfloat16)
    out, grads = _port(q, k, v, do, causal, window, qc, kc)
    want_out, want_grads = _ref(q, k, v, do, causal, window, qc, kc)
    assert out.dtype == want_out.dtype == ml_dtypes.bfloat16
    assert _within_a_bf16_ulp(out, want_out)
    for got, want in zip(grads, want_grads):
        assert got.dtype == ml_dtypes.bfloat16 and _within_a_bf16_ulp(got, want)


@pytest.mark.parametrize("arch", ["yi-6b", "h2o-danube-3-4b"])
def test_blocked_attention_prefill_and_its_gradients_equal_the_reference(arch):
    cfg, tcfg = jax_config(arch, smoke=True), get_model_config(arch, smoke=True)
    jp = JA.init_attention(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 80, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(2, 80, cfg.d_model)).astype(np.float32)
    window = cfg.window if cfg.attention == "swa" else None

    def ref(p, xx):
        return JA.attention_prefill(p, xx, cfg, window=window, impl="blocked")[0]

    want, vjp = jax.vjp(ref, jp, jnp.asarray(x))
    want_gp, want_gx = vjp(jnp.asarray(dy))
    tp = {k: t.requires_grad_(True)
          for k, t in params_from_numpy(jax.tree.map(np.asarray, jp), "cpu").items()}
    tx = _t(x).requires_grad_(True)
    got, _ = A.attention_prefill(tp, tx, tcfg, window=window, impl="blocked")
    grads = torch.autograd.grad(got, [tx] + [tp[k] for k in sorted(tp)], _t(dy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL, rtol=0)
    _close_scaled(grads[0].numpy(), want_gx, "dx")
    for key, gr in zip(sorted(tp), grads[1:]):
        _close_scaled(gr.numpy(), want_gp[key], key)


# ---------------------------------------------------------------------------
# softmax_xent: the memory-lean VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_value_and_gradient_equal_the_reference(masked):
    rng = np.random.default_rng(1)
    logits = (3 * rng.normal(size=(2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, size=(2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32) if masked else None

    def ref(lg):
        return JL.softmax_xent(lg, jnp.asarray(labels),
                               None if mask is None else jnp.asarray(mask))

    want, want_g = jax.value_and_grad(ref)(jnp.asarray(logits))
    tl = _t(logits).requires_grad_(True)
    got = L.softmax_xent(tl, torch.as_tensor(labels),
                         None if mask is None else torch.as_tensor(mask))
    (g,) = torch.autograd.grad(got, [tl])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL)
    _close_scaled(g.numpy(), want_g, "dlogits")


def test_softmax_xent_saves_no_fp32_copy_of_the_logits():
    b, s, v = 2, 8, 300
    rng = np.random.default_rng(2)
    logits = torch.as_tensor(rng.normal(size=(b, s, v)).astype(np.float32)).to(torch.bfloat16)
    logits.requires_grad_(True)
    labels = torch.as_tensor(rng.integers(0, v, size=(b, s)))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append((t.dtype, tuple(t.shape))) or t, lambda t: t):
        loss = L.softmax_xent(logits, labels)
    full = [(dt, sh) for dt, sh in saved if sh == (b, s, v)]
    assert full == [(torch.bfloat16, (b, s, v))], saved
    (g,) = torch.autograd.grad(loss, [logits])
    assert g.dtype == torch.bfloat16


def _plain_xent(logits, labels, m):
    lf = logits.float()
    nll = torch.logsumexp(lf, -1) - lf.gather(-1, labels.long()[..., None])[..., 0]
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


def test_softmax_xent_gives_autograd_bits_for_fp32_logits():
    """The custom backward takes autograd's order of operations, so the FL
    tasks' fp32 losses and gradients are what they were before it, also
    under ``torch.func.vmap(grad(...))`` (the vmapped executor)."""
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.normal(size=(3, 6, 40)).astype(np.float32))
    x = torch.as_tensor(rng.normal(size=(3, 5, 6)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 40, size=(3, 5)))
    m = torch.as_tensor((rng.random((3, 5)) > 0.3).astype(np.float32))
    mine = torch.func.vmap(torch.func.grad_and_value(lambda w, x, y, m: L.softmax_xent(x @ w, y, m)))
    plain = torch.func.vmap(torch.func.grad_and_value(lambda w, x, y, m: _plain_xent(x @ w, y, m)))
    (g1, l1), (g2, l2) = mine(w, x, y, m), plain(w, x, y, m)
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    lg = (x[0] @ w[0]).requires_grad_(True)
    (ga,) = torch.autograd.grad(L.softmax_xent(lg, y[0]), [lg])
    (gb,) = torch.autograd.grad(_plain_xent(lg, y[0], torch.ones(5)), [lg])
    assert torch.equal(ga, gb)
