"""pairwise_rank in the port against the JAX reference, on the CPU.

The port's plain version and its op (what CPU tensors take; the CUDA kernels
are held to the plain version on the card by ``chip_smoke.py``) against
``repro``'s jnp oracle, the Pallas kernel in interpret mode and ``jax.grad``
of the custom-VJP loss.  The kernels' gradient is one row reduction,
``2 / count * sum_j pm_ij (sigmoid(s_i - s_j) - tgt_ij)``; that formula is
held to ``jax.grad`` here in float64, so the identity the gradient kernel
rests on is tested where there is no card.

Tolerance: loss and gradient within 1e-5 (fp32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.pairwise_rank.kernel import pairwise_rank_pallas
from repro.kernels.pairwise_rank.ops import pairwise_rank_loss
from repro.kernels.pairwise_rank.ref import pairwise_rank_ref as jax_ref
from repro_torch.core.ranking import pairwise_bce_hard
from repro_torch.kernels.pairwise_rank import ops as tops
from repro_torch.kernels.pairwise_rank.kernel import (
    pairwise_rank_fused_cuda,
    pairwise_rank_fwd_cuda,
)
from repro_torch.kernels.pairwise_rank.ops import pairwise_rank
from repro_torch.kernels.pairwise_rank.ref import pairwise_rank_fused_ref, pairwise_rank_ref

TOL = 1e-5


def _inputs(b, n, seed, masked_frac=0.3):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(b, n)).astype(np.float32)
    t = rng.normal(size=(b, n)).astype(np.float32)
    m = (rng.random((b, n)) > masked_frac).astype(np.float32)
    return s, t, m


_jax_loss = jax.jit(jax_ref, static_argnums=3)
_jax_grad = jax.jit(jax.grad(pairwise_rank_loss), static_argnums=3)


def _jax_row(s, t, m, hard):
    """(loss of the oracle, loss of the Pallas kernel, jax.grad through the
    custom VJP) for one row."""
    s, t, m = jnp.asarray(s), jnp.asarray(t), jnp.asarray(m)
    loss = float(_jax_loss(s, t, m, hard))
    pallas = float(pairwise_rank_pallas(s, t, m, hard=hard))
    grad = np.asarray(_jax_grad(s, t, m, hard))
    return loss, pallas, grad


def _port(s, t, m, hard):
    st = torch.tensor(s, requires_grad=True)
    loss = pairwise_rank(st, torch.tensor(t), torch.tensor(m), hard=hard)
    (grad,) = torch.autograd.grad(loss.sum(), st)
    return loss.detach().numpy(), grad.numpy()


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
@pytest.mark.parametrize("n", [1, 30, 129, 300])
def test_loss_and_grad_match_reference(n, hard):
    s, t, m = _inputs(3, n, seed=n)
    s[1, : n // 2] = s[1, 0]                   # duplicated scores: l = 0 pairs
    t[2, : n // 3] = t[2, 0]                   # tied targets: 0.5 when hard
    loss, grad = _port(s, t, m, hard)
    plain = pairwise_rank_ref(torch.tensor(s), torch.tensor(t), torch.tensor(m),
                              hard).numpy()
    np.testing.assert_allclose(plain, loss, rtol=0, atol=0)
    for row in range(3):
        j_loss, j_pallas, j_grad = _jax_row(s[row], t[row], m[row], hard)
        np.testing.assert_allclose(loss[row], j_loss, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(loss[row], j_pallas, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(grad[row], j_grad, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_batch_equals_loop_over_rows(hard):
    s, t, m = _inputs(5, 40, seed=7)
    loss, grad = _port(s, t, m, hard)
    for row in range(5):
        l1, g1 = _port(s[row], t[row], m[row], hard)
        np.testing.assert_allclose(loss[row], l1, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(grad[row], g1, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_all_masked_row_is_zero(hard):
    s, t, m = _inputs(2, 30, seed=3)
    m[0] = 0.0
    loss, grad = _port(s, t, m, hard)
    assert loss[0] == 0.0 and not grad[0].any()
    j_loss, _, j_grad = _jax_row(s[0], t[0], m[0], hard)
    assert j_loss == 0.0 and not j_grad.any()


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_constant_scores_and_fractional_mask(hard):
    """Every logit 0 (the max/abs kinks) and a mask with a fractional
    entry."""
    _, t, m = _inputs(1, 30, seed=4)
    s = np.full((1, 30), 0.25, np.float32)
    m[0, 5] = 0.5
    loss, grad = _port(s, t, m, hard)
    j_loss, j_pallas, j_grad = _jax_row(s[0], t[0], m[0], hard)
    np.testing.assert_allclose(loss[0], j_loss, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(loss[0], j_pallas, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(grad[0], j_grad, rtol=TOL, atol=TOL)


def _row_reduction_grad(s, t, m, hard):
    """The gradient kernels' formula, float64 numpy."""
    s, t, m = (np.asarray(x, np.float64) for x in (s, t, m))
    l = s[:, None] - s[None, :]
    d = t[:, None] - t[None, :]
    tgt = (np.where(d > 0, 1.0, np.where(d < 0, 0.0, 0.5)) if hard
           else 1.0 / (1.0 + np.exp(-d)))
    pm = m[:, None] * m[None, :] * (1.0 - np.eye(len(s)))
    count = max(pm.sum(), 1.0)
    return 2.0 / count * (pm * (1.0 / (1.0 + np.exp(-l)) - tgt)).sum(1)


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
@pytest.mark.parametrize("n", [2, 30, 200])
def test_row_reduction_gradient_equals_autodiff(n, hard):
    s, t, m = _inputs(1, n, seed=100 + n)
    s[0, : n // 2] = s[0, 0]
    j_grad = np.asarray(_jax_grad(*(jnp.asarray(x[0]) for x in (s, t, m)), hard))
    np.testing.assert_allclose(_row_reduction_grad(s[0], t[0], m[0], hard),
                               j_grad, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_kernel_wrappers_take_the_plain_version_on_cpu(hard):
    s, t, m = _inputs(4, 50, seed=9)
    st, tt, mt = torch.tensor(s), torch.tensor(t), torch.tensor(m)
    fwd0, fused0 = pairwise_rank_fwd_cuda.launches, pairwise_rank_fused_cuda.launches
    loss, count = pairwise_rank_fwd_cuda(st, tt, mt, hard=hard)
    assert count.dtype == torch.float64
    pm = m[:, :, None] * m[:, None, :] * (1.0 - np.eye(50))
    np.testing.assert_array_equal(count.numpy(), pm.sum((1, 2)))
    np.testing.assert_array_equal(loss.numpy(),
                                  pairwise_rank_ref(st, tt, mt, hard).numpy())
    g = torch.tensor([1.0, 0.5, -2.0, 0.0])
    _, _, grad = pairwise_rank_fused_cuda(st, tt, mt, hard=hard)
    grad = g[:, None] * grad
    for row in range(4):
        expect = g[row].item() * _row_reduction_grad(s[row], t[row], m[row], hard)
        np.testing.assert_allclose(grad[row].numpy(), expect, rtol=TOL, atol=TOL)
    # the plain version is not a launch
    assert (pairwise_rank_fwd_cuda.launches, pairwise_rank_fused_cuda.launches) == (
        fwd0, fused0)


def test_leading_dims_and_gradient_to_scores_only():
    s, t, m = _inputs(6, 12, seed=11)
    st = torch.tensor(s.reshape(2, 3, 12), requires_grad=True)
    tt = torch.tensor(t.reshape(2, 3, 12), requires_grad=True)
    loss = pairwise_bce_hard(st, tt, torch.tensor(m.reshape(2, 3, 12)))
    assert loss.shape == (2, 3)
    flat, _ = _port(s, t, m, True)
    np.testing.assert_allclose(loss.detach().numpy().ravel(), flat, rtol=0, atol=0)
    loss.sum().backward()
    assert st.grad is not None and tt.grad is None
    scalar = pairwise_rank(torch.tensor(s[0]), torch.tensor(t[0]),
                           torch.tensor(m[0]))
    assert scalar.shape == ()


def test_other_devices_raise():
    x = torch.zeros((2, 5), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        pairwise_rank_fwd_cuda(x, x, x, hard=True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        pairwise_rank(x, x, x, hard=True)


# ---------------------------------------------------------------------------
# the fused launch: loss, count and gradient together
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
@pytest.mark.parametrize("n", [1, 8, 30, 129])
def test_fused_plain_version_matches_jax_grad(n, hard):
    s, t, m = _inputs(3, n, seed=200 + n)
    s[1, : n // 2] = s[1, 0]                   # duplicated scores: l = 0 pairs
    t[2, : n // 3] = t[2, 0]                   # tied targets: 0.5 when hard
    loss, count, grad = pairwise_rank_fused_ref(torch.tensor(s), torch.tensor(t),
                                                torch.tensor(m), hard)
    assert count.dtype == torch.float64 and grad.shape == (3, n)
    pm = m[:, :, None] * m[:, None, :] * (1.0 - np.eye(n))
    np.testing.assert_array_equal(count.numpy(), pm.sum((1, 2)))
    for row in range(3):
        j_loss, _, j_grad = _jax_row(s[row], t[row], m[row], hard)
        np.testing.assert_allclose(loss[row].item(), j_loss, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(grad[row].numpy(), j_grad, rtol=TOL, atol=TOL)


def _two_diff(a, b):
    """fp32 a - b and its exact rounding error (pairwise_rank.cu two_diff_err)."""
    s = (a - b).astype(np.float32)
    bb = (s - a).astype(np.float32)
    return s, ((a - (s - bb)).astype(np.float32) + (-b - bb).astype(np.float32)).astype(np.float32)


def _kernel_terms(s, t, hard):
    """float32 numpy emulation of pairwise_rank.cu's pair_terms gradient
    term sigmoid(l) - tgt, (B, N, N), from e = exp(-|l|) without
    cancellation."""
    f32 = np.float32
    si, sj, ti, tj = s[:, :, None], s[:, None, :], t[:, :, None], t[:, None, :]
    l, l_lo = _two_diff(si, sj)
    d, d_lo = _two_diff(ti, tj)
    e = np.exp(-np.abs(l)).astype(f32)
    with np.errstate(over="ignore", invalid="ignore"):   # branches the kernel does not take
        if hard:
            inv = (f32(1) / (f32(1) + e)).astype(f32)
            pos = l >= 0
            t1 = np.where(pos, -(e * inv), -inv)
            t0 = np.where(pos, inv, e * inv)
            th = np.where(pos, f32(-0.5), f32(0.5)) * np.expm1(-np.abs(l)).astype(f32) * inv
            return np.where(d > 0, t1, np.where(d < 0, t0, th)).astype(f32)
        ed = np.exp(-np.abs(d)).astype(f32)
        delta = ((l - d).astype(f32) + (l_lo - d_lo).astype(f32)).astype(f32)
        ad = np.abs(delta)
        half = (f32(-0.5) * (np.abs(l) + np.abs(d))).astype(f32)
        lo = np.exp((half - f32(0.5) * ad).astype(f32)).astype(f32)
        hi = np.exp((half + f32(0.5) * ad).astype(f32)).astype(f32)
        num = np.where(ad < 1, lo * np.expm1(ad).astype(f32), (hi - lo).astype(f32))
        return (np.copysign(num, delta) / ((f32(1) + e) * (f32(1) + ed))).astype(f32)


def _fp64_terms(s, t, hard):
    """sigmoid(l) - tgt in float64 through identities with no cancellation
    at any |l| (the plain sigmoid rounds to 1 past |l| ~ 37 and would lose
    the far-apart cases' whole gradient): 1 - sigmoid(l) = sigmoid(-l),
    sigmoid(l) - 1/2 = tanh(l/2) / 2, sigmoid(l) - sigmoid(d) =
    sinh((l - d)/2) / (2 cosh(l/2) cosh(d/2))."""
    s, t = s.astype(np.float64), t.astype(np.float64)
    l = s[:, :, None] - s[:, None, :]
    d = t[:, :, None] - t[:, None, :]
    with np.errstate(over="ignore"):
        if hard:
            return np.where(d > 0, -1.0 / (1.0 + np.exp(l)),
                            np.where(d < 0, 1.0 / (1.0 + np.exp(-l)), 0.5 * np.tanh(l / 2)))
        return np.sinh((l - d) / 2) / (2 * np.cosh(l / 2) * np.cosh(d / 2))


def _cohorts(case, rng, b=4000, n=8):
    s = rng.normal(size=(b, n)).astype(np.float32)
    t = rng.normal(size=(b, n)).astype(np.float32)
    if case == "duplicated-scores":
        s = rng.integers(0, 3, (b, n)).astype(np.float32)
    elif case == "tied-targets":
        t = rng.integers(0, 3, (b, n)).astype(np.float32)
    elif case == "scores-equal-targets":            # soft terms cancel exactly
        s = t.copy()
    elif case == "scores-near-targets":             # ... and nearly
        s = (t + rng.normal(size=(b, n)) * 1e-4).astype(np.float32)
    elif case == "far-apart":                       # sigmoids saturate in fp32
        s = (s * 10).astype(np.float32)
        t = (t * 10).astype(np.float32)
    return s, t


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
@pytest.mark.parametrize("case", ["random", "duplicated-scores", "tied-targets",
                                  "scores-equal-targets", "scores-near-targets",
                                  "far-apart"])
def test_stable_pair_terms_match_fp64(case, hard):
    """The kernel's fp32 gradient terms, summed in fp64 as its rows are,
    within 1e-5 of the row's largest |g| of an fp64 evaluation: the
    chip_smoke.py tolerance that fp32 sigmoid(l) - tgt misses on some soft
    cohorts."""
    rng = np.random.default_rng(hash(case) % 2**32)
    s, t = _cohorts(case, rng)
    m = (rng.random(s.shape) > 0.3).astype(np.float64)
    pm = m[:, :, None] * m[:, None, :] * (1.0 - np.eye(s.shape[1]))
    got = (_kernel_terms(s, t, hard).astype(np.float64) * pm).sum(2)
    want = (_fp64_terms(s, t, hard) * pm).sum(2)
    assert np.isfinite(got).all()
    g_max = np.abs(want).max(1, keepdims=True)
    assert (np.abs(got - want) <= TOL * g_max).all()
    if case == "scores-equal-targets" and not hard:
        assert not got.any()                        # exact cancellation stays exact


def _log1p_01(e):
    """float32 numpy emulation of pairwise_rank.cu's log1p_01, the loss
    term log(1 + e) for e in [0, 1] (the card's reciprocal is within 1 ulp
    of the correctly rounded one used here; a fused multiply-add rounds
    once, as the fp64 product and sum rounded to fp32 do)."""
    f32 = np.float32
    e = np.asarray(e, f32)
    z = (e * (f32(1) / (f32(2) + e)).astype(f32)).astype(f32)
    w = (z * z).astype(f32)
    p = np.full_like(z, f32(1.0 / 13.0))
    for c in (1 / 11, 1 / 9, 1 / 7, 1 / 5, 1 / 3, 1.0):
        p = (p.astype(np.float64) * w + np.float64(f32(c))).astype(f32)
    return ((f32(2) * z).astype(f32) * p).astype(f32)


def test_loss_term_keeps_relative_accuracy():
    """Every e = exp(-|l|) an fp32 score difference gives, down to the
    smallest normal: within 1e-6 relative of fp64 log1p (the rounded 1 + e
    under a logarithm is off by up to 100% once e < 6e-8)."""
    e = np.concatenate([[0.0, 1.0], np.exp(-np.linspace(0.0, 87.0, 20001))]).astype(
        np.float32)
    got = _log1p_01(e).astype(np.float64)
    want = np.log1p(e.astype(np.float64))
    assert got[0] == 0.0
    assert (np.abs(got - want) <= 1e-6 * want).all()


@pytest.mark.parametrize("gap", [4.0, 10.0, 20.0])
def test_well_ranked_cohort_loss_keeps_relative_accuracy(gap):
    """Hard targets, scores ordered as the targets with ``gap`` between
    neighbours: each pair's BCE is log1p(e) alone (the max and target terms
    cancel exactly in fp32), so the kernel's fp32 terms summed in fp64 give
    the loss within 1e-5 relative of fp64, however small it is."""
    rng = np.random.default_rng(int(gap))
    n = 30
    t = rng.normal(size=n).astype(np.float32)
    s = (gap * np.argsort(np.argsort(t))).astype(np.float32)
    l = (s[:, None] - s[None, :]).astype(np.float32)
    d = t[:, None] - t[None, :]
    tgt = np.where(d > 0, 1.0, np.where(d < 0, 0.0, 0.5)).astype(np.float32)
    e = np.exp(-np.abs(l)).astype(np.float32)
    bce = (np.maximum(l, 0) - l * tgt).astype(np.float32) + _log1p_01(e)
    off = ~np.eye(n, dtype=bool)
    got = bce.astype(np.float64)[off].mean()
    l64 = s.astype(np.float64)[:, None] - s.astype(np.float64)[None, :]
    want = np.log1p(np.exp(-np.abs(l64)))[off].mean()
    assert 0 < want < 0.02
    assert abs(got - want) <= 1e-5 * want


@pytest.mark.parametrize("hard", [True, False], ids=["hard", "soft"])
def test_fused_wrapper_takes_the_plain_version_on_cpu(hard):
    s, t, m = _inputs(4, 50, seed=21)
    st, tt, mt = torch.tensor(s), torch.tensor(t), torch.tensor(m)
    before = pairwise_rank_fused_cuda.launches
    loss, count, grad = pairwise_rank_fused_cuda(st, tt, mt, hard=hard)
    ref_loss, ref_count = pairwise_rank_fwd_cuda(st, tt, mt, hard=hard)
    assert torch.equal(loss, ref_loss) and torch.equal(count, ref_count)
    for row in range(4):
        np.testing.assert_allclose(grad[row].numpy(),
                                   _row_reduction_grad(s[row], t[row], m[row], hard),
                                   rtol=TOL, atol=TOL)
    assert pairwise_rank_fused_cuda.launches == before


def test_autograd_route_saves_the_gradient_only_when_scores_require_it(monkeypatch):
    """The route the card takes, driven with CPU tensors (the wrappers then
    take their plain versions): a fused call whose gradient autograd saves
    when the scores need one, the loss-only call otherwise."""
    calls = []
    for name in ("pairwise_rank_fused_cuda", "pairwise_rank_fwd_cuda"):
        real = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    s, t, m = (torch.tensor(x) for x in _inputs(3, 30, seed=5))
    x = s.clone().requires_grad_(True)
    loss = tops._loss_on_card(x, t, m, True)
    assert calls == ["pairwise_rank_fused_cuda"]
    (saved,) = loss.grad_fn.saved_tensors
    _, _, want = pairwise_rank_fused_ref(s, t, m, True)
    assert torch.equal(saved, want)
    g = torch.tensor([1.0, -0.5, 2.0])
    (grad,) = torch.autograd.grad(loss, x, g)
    assert torch.equal(grad, g[:, None] * want)
    calls.clear()
    with torch.no_grad():
        loss = tops._loss_on_card(x, t, m, True)
    assert calls == ["pairwise_rank_fwd_cuda"] and loss.grad_fn is None
    calls.clear()
    loss = tops._loss_on_card(s, t, m, True)        # scores need no gradient
    assert calls == ["pairwise_rank_fwd_cuda"] and loss.grad_fn is None
    np.testing.assert_array_equal(loss.numpy(), pairwise_rank_ref(s, t, m, True).numpy())
