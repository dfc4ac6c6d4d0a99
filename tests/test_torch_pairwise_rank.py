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
from repro_torch.kernels.pairwise_rank.kernel import (
    pairwise_rank_bwd_cuda,
    pairwise_rank_fwd_cuda,
)
from repro_torch.kernels.pairwise_rank.ops import pairwise_rank
from repro_torch.kernels.pairwise_rank.ref import pairwise_rank_ref

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
    fwd0, bwd0 = pairwise_rank_fwd_cuda.launches, pairwise_rank_bwd_cuda.launches
    loss, count = pairwise_rank_fwd_cuda(st, tt, mt, hard=hard)
    assert count.dtype == torch.float64
    pm = m[:, :, None] * m[:, None, :] * (1.0 - np.eye(50))
    np.testing.assert_array_equal(count.numpy(), pm.sum((1, 2)))
    np.testing.assert_array_equal(loss.numpy(),
                                  pairwise_rank_ref(st, tt, mt, hard).numpy())
    g = torch.tensor([1.0, 0.5, -2.0, 0.0])
    grad = pairwise_rank_bwd_cuda(st, tt, mt, count, g, hard=hard)
    for row in range(4):
        expect = g[row].item() * _row_reduction_grad(s[row], t[row], m[row], hard)
        np.testing.assert_allclose(grad[row].numpy(), expect, rtol=TOL, atol=TOL)
    # the plain version is not a launch
    assert (pairwise_rank_fwd_cuda.launches, pairwise_rank_bwd_cuda.launches) == (
        fwd0, bwd0)


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
