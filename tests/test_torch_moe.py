"""The port's mixture-of-experts layer (``repro_torch.models.moe``) against
the JAX reference (``repro.models.moe``), on the CPU.

Weights come from the reference's ``init_moe`` and are carried across with
``repro_torch.convert``; inputs are made with numpy from a seed.
Tolerances:

* the routing's expert ids, the per-expert capacity, the dispatch's
  slot -> token map and the dropped fraction: exactly equal;
* the routing's gates, the slot gates and the aux terms: 1e-6 (the same
  fp32 softmax, another kernel);
* the layer's output y: 1e-5 (fp32 sums in another order: the port
  gathers each token's k expert outputs where the reference scatter-adds);
* the gradient of ``sum(y**2) + moe_aux_loss`` by every leaf: 1e-5 of the
  leaf's largest magnitude (max 1), the same sums through a backward;
* ``torch.func.vmap(grad(...))`` over a batch of clients against the
  per-client loop: 1e-6 (the same operations, batched).

The reference's four property tests (``tests/test_moe_ssm.py``) are
ported below as they are.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.models import moe as JM
from repro_torch.configs import get_model_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import moe as M


def _cfgs(n_groups=1, capacity_factor=None, dispatch="sort", arch="olmoe-1b-7b"):
    """The reference's ``_moe_setup`` for both packages."""
    out = []
    for get in (jax_config, get_model_config):
        cfg = get(arch, smoke=True)
        moe = dataclasses.replace(
            cfg.moe, dispatch=dispatch, n_groups=n_groups,
            **({"capacity_factor": capacity_factor} if capacity_factor else {}))
        out.append(dataclasses.replace(cfg, moe=moe))
    return out


def _params(jcfg, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _scaled_close(got, want, tol, what):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


CASES = [(1, None, "sort"), (2, None, "sort"), (4, None, "sort"), (1, None, "dense"),
         (1, 0.25, "sort"), (2, 0.25, "sort"), (4, 0.25, "sort"), (1, 0.25, "dense")]


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "phi3.5-moe"])
@pytest.mark.parametrize("n_groups,factor,dispatch", CASES)
def test_apply_moe_matches_the_reference(arch, n_groups, factor, dispatch):
    jcfg, tcfg = _cfgs(n_groups, factor, dispatch, arch)
    jp, tp = _params(jcfg)
    x = _x((2, 32, jcfg.d_model))
    # the routing: expert ids exactly, gates and aux to 1e-6
    jg, ji, jaux = JM._route(jp, jnp.asarray(x.reshape(64, -1)), jcfg.moe)
    tg, ti, taux = M._route(tp, torch.as_tensor(x.reshape(64, -1)), tcfg.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    # the layer
    jy, jaux = jax.jit(lambda p, x: JM.apply_moe(p, x, jcfg))(jp, jnp.asarray(x))
    ty, taux = M.apply_moe(tp, torch.as_tensor(x), tcfg)
    assert sorted(taux) == sorted(jaux)
    for key in jaux:
        np.testing.assert_allclose(np.asarray(taux[key]), np.asarray(jaux[key]),
                                   atol=1e-6, rtol=0, err_msg=key)
    assert (float(taux["dropped_fraction"]) > 0) == (factor is not None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)

    def jloss(p):
        y, aux = JM.apply_moe(p, jnp.asarray(x), jcfg)
        return jnp.sum(jnp.square(y)) + JM.moe_aux_loss(aux, jcfg)

    jgrad = jax.jit(jax.grad(jloss))(jp)
    live = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    y, aux = M.apply_moe(live, torch.as_tensor(x), tcfg)
    (torch.sum(torch.square(y)) + M.moe_aux_loss(aux, tcfg)).backward()
    assert sorted(live) == sorted(jgrad)
    for key in jgrad:
        _scaled_close(live[key].grad.numpy(), jgrad[key], 1e-5, key)


@pytest.mark.parametrize("factor", [None, 0.25])
def test_sort_dispatch_matches_the_reference_group_by_group(factor):
    """Each group's slot -> token map exactly, its slot gates and dropped
    fraction as the reference's ``_sort_dispatch_group`` gives them."""
    jcfg, tcfg = _cfgs(4, factor)
    jp, tp = _params(jcfg, seed=1)
    moe = jcfg.moe
    x = _x((2, 32, jcfg.d_model), seed=1)
    g, tg = 4, 16
    cap = JM._capacity(tg, moe.n_experts, moe.top_k, moe.capacity_factor)
    assert M._capacity(tg, moe.n_experts, moe.top_k, moe.capacity_factor) == cap
    jgate, jidx, _ = JM._route(jp, jnp.asarray(x.reshape(64, -1)), moe)
    xin, slot_token, slot_gate, dropped, token_slot = M._sort_dispatch_group(
        torch.as_tensor(x.reshape(g, tg, -1)), torch.as_tensor(np.array(jgate)).reshape(g, tg, -1),
        torch.as_tensor(np.array(jidx)).reshape(g, tg, -1), moe.n_experts, cap, moe.top_k)
    for i in range(g):
        rows = slice(i * tg, (i + 1) * tg)
        wx, wtok, wgate, wdrop = JM._sort_dispatch_group(
            jnp.asarray(x.reshape(64, -1)[rows]), jgate[rows], jidx[rows], moe.n_experts,
            cap, moe.top_k)
        np.testing.assert_array_equal(slot_token[i].numpy(), np.asarray(wtok))
        np.testing.assert_allclose(slot_gate[i].numpy(), np.asarray(wgate), atol=1e-6, rtol=0)
        np.testing.assert_array_equal(xin[i].numpy(), np.asarray(wx))
        assert float(dropped[i]) == float(wdrop)
        # every kept (token, choice) names the slot whose token it is
        kept = token_slot[i] < moe.n_experts * cap
        tokens = torch.arange(tg * moe.top_k) // moe.top_k
        assert torch.equal(slot_token[i][token_slot[i][kept]], tokens[kept])


def test_capacity_equals_the_reference():
    for n in (1, 4, 7, 64, 1000, 4096):
        for e, k, f in ((4, 2, 2.0), (64, 8, 1.25), (16, 2, 1.25), (4, 2, 0.25)):
            assert M._capacity(n, e, k, f) == JM._capacity(n, e, k, f), (n, e, k, f)


def test_routing_ties_go_to_the_lowest_index():
    """A zero router gives every expert the same probability: the top k are
    experts 0..k-1, in that order, as ``jax.lax.top_k`` picks them."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x((16, jcfg.d_model))
    _, ji, _ = JM._route(jp, jnp.asarray(x), jcfg.moe)
    _, ti, _ = M._route(tp, torch.as_tensor(x), tcfg.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert torch.equal(ti, torch.arange(tcfg.moe.top_k).expand(16, -1))


# ---------------------------------------------------------------------------
# the reference's property tests (tests/test_moe_ssm.py), ported
# ---------------------------------------------------------------------------


def _port_setup(n_groups=1, capacity_factor=None, dispatch="sort", seed=0):
    cfg = _cfgs(n_groups, capacity_factor, dispatch)[1]
    gen = torch.Generator().manual_seed(seed)
    return cfg, M.init_moe(gen, cfg, torch.float32), gen


@pytest.mark.parametrize("n_groups", [1, 2, 4])
def test_moe_sort_equals_dense_lossless(n_groups):
    cfg_s, p, gen = _port_setup(n_groups=n_groups)
    cfg_d = _cfgs(dispatch="dense")[1]
    x = torch.randn((2, 32, cfg_s.d_model), generator=gen)
    ys, aux_s = M.apply_moe(p, x, cfg_s)
    yd, aux_d = M.apply_moe(p, x, cfg_d)
    assert float(aux_s["dropped_fraction"]) == 0.0
    np.testing.assert_allclose(ys.numpy(), yd.numpy(), atol=1e-5)


def test_moe_capacity_drops_tokens():
    cfg, p, gen = _port_setup(capacity_factor=0.25, seed=1)
    x = torch.randn((2, 64, cfg.d_model), generator=gen)
    y, aux = M.apply_moe(p, x, cfg)
    assert float(aux["dropped_fraction"]) > 0.0
    assert not torch.isnan(y).any()


def test_moe_load_balance_loss_bounds():
    """Uniform routing -> lb loss ~= 1 (its minimum); it must never be < 1-eps."""
    cfg, p, gen = _port_setup(seed=2)
    x = torch.randn((2, 128, cfg.d_model), generator=gen)
    _, aux = M.apply_moe(p, x, cfg)
    assert float(aux["load_balance_loss"]) >= 1.0 - 1e-3
    np.testing.assert_allclose(float(aux["expert_fraction"].sum()), 1.0, atol=1e-5)


def test_moe_gradients_flow_sort():
    cfg, p, gen = _port_setup(n_groups=2, seed=3)
    x = torch.randn((1, 32, cfg.d_model), generator=gen)
    live = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    y, aux = M.apply_moe(live, x, cfg)
    (torch.sum(torch.square(y)) + M.moe_aux_loss(aux, cfg)).backward()
    gnorm = sum(float(v.grad.abs().sum()) for v in live.values())
    assert np.isfinite(gnorm) and gnorm > 0
    # router must receive gradient (via gates and aux losses)
    assert float(live["router"].grad.abs().sum()) > 0


# ---------------------------------------------------------------------------
# torch.func: the vmapped FL executor's vmap(grad(...))
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_groups,factor,dispatch", [(2, 0.5, "sort"), (1, None, "sort"),
                                                      (1, 0.5, "dense")])
def test_vmap_grad_over_clients_equals_the_loop(n_groups, factor, dispatch):
    """Three clients, each with its own experts and tokens (so each routes
    and drops differently), under ``vmap(grad(...))`` with no fallback
    warning: the per-client gradients within 1e-6."""
    from torch.func import grad, vmap

    cfg = _cfgs(n_groups, factor, dispatch)[1]
    gen = torch.Generator().manual_seed(4)
    p = M.init_moe(gen, cfg, torch.float32, (3,))
    x = torch.randn((3, 2, 16, cfg.d_model), generator=gen)

    def loss(pp, xx):
        y, aux = M.apply_moe(pp, xx, cfg)
        return torch.sum(torch.square(y)) + M.moe_aux_loss(aux, cfg)

    with warnings.catch_warnings():
        warnings.simplefilter("error")          # a per-client fallback warns
        batched = vmap(grad(loss))(p, x)
    for i in range(3):
        alone = grad(loss)({k: v[i] for k, v in p.items()}, x[i])
        for key in alone:
            np.testing.assert_allclose(batched[key][i].numpy(), alone[key].numpy(),
                                       atol=1e-6, rtol=0, err_msg=(i, key))
