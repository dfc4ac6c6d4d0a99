"""The port's cohort-batched client training against the JAX reference.

``make_parallel_local_train`` and ``VmappedExecutor`` take the same numpy
requests (client shards, seeds, epochs, inits) as the reference's
``VmappedExecutor`` and must give the same per-client params and per-epoch
losses within 1e-5 (fp32 sums in another order), and the port's own
``SequentialExecutor`` within 1e-5 too.  The shuffle orders come from the
same ``np.random.default_rng(seed)`` draws, so nothing but rounding may
differ.  Covered: a shared and a per-client (stacked) init, FedProx
(``prox_mu > 0``), mixed (padded size, epochs) buckets and ``epochs = 0``.

Whole runs: two rounds of ``fedavg`` and ``fedmarl`` pick the same cohorts
under ``"sequential"`` and ``"vmapped"`` (global params within 1e-5), and
``AsyncDispatchExecutor(inner="vmapped")`` drives an asynchronous run that
schedules the same jobs as the sequential inner executor.  Small sizes only:
20 devices, a 32 -> 32 -> 10 MLP.
"""
import numpy as np
import pytest
import torch

import repro.fl as jfl
import repro.fl.client as jclient
import repro.fl.engine as jengine
import repro_torch.data as tdata
import repro_torch.fl as tfl
import repro_torch.fl.client as tclient
import repro_torch.fl.engine as tengine
from repro_torch.convert import params_from_numpy, params_to_numpy

TOL = 1e-5


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _cpu(tree):
    return params_from_numpy(_np(tree), "cpu")


def _tdata(fl_data):
    return tdata.FederatedData(fl_data.train, fl_data.test, fl_data.client_indices)


def _assert_tree_close(ref, got, tol=TOL):
    ref, got = _np(ref), params_to_numpy(got)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol, err_msg=k)


def _global(mlp_task, seed=0):
    import jax

    return mlp_task.init(jax.random.PRNGKey(seed))


# (client, samples, epochs): sizes spread over the 8..256 buckets, two epoch
# counts sharing a bucket, and a pass-through request
REQUESTS = ((0, 40, 2), (1, 25, 2), (2, 120, 1), (3, 64, 2), (4, 9, 2),
            (5, 33, 1), (6, 0, 0), (7, 200, 2))


def _requests(fl_data, jgp, *, stacked, module, as_tensor=False):
    rng = np.random.default_rng(4)
    reqs = []
    for c, n, epochs in REQUESTS:
        idx = fl_data.client_indices[c][:max(n, 5)]
        x, y = fl_data.train.x[idx], fl_data.train.y[idx]
        init = None
        if stacked and c % 2 == 0:
            init = {k: (np.asarray(v) + 0.01 * rng.standard_normal(v.shape)
                        ).astype(np.float32) for k, v in jgp.items()}
            if as_tensor:
                init = params_from_numpy(init, "cpu")
        if as_tensor:
            x, y = torch.as_tensor(x), torch.as_tensor(y)
        reqs.append(module.ClientRequest(c, x, y, epochs=epochs, seed=100 + c,
                                         init_params=init))
    return reqs


@pytest.mark.parametrize("stacked", [False, True], ids=["shared", "stacked"])
@pytest.mark.parametrize("prox_mu", [0.0, 0.1])
def test_vmapped_executor_equals_reference(mlp_task, fl_data, stacked, prox_mu):
    jgp = _global(mlp_task)
    kw = dict(lr=0.1, batch_size=16, prox_mu=prox_mu)
    jres = jengine.VmappedExecutor().run(
        mlp_task, jgp, _requests(fl_data, jgp, stacked=stacked, module=jengine), **kw)
    treqs = _requests(fl_data, jgp, stacked=stacked, module=tengine, as_tensor=True)
    tgp = _cpu(jgp)
    vres = tfl.make_executor("vmapped").run(tfl.MLPTask(dim=32, hidden=32), tgp,
                                            treqs, **kw)
    sres = tfl.SequentialExecutor().run(tfl.MLPTask(dim=32, hidden=32), tgp,
                                        treqs, **kw)
    assert set(vres.params) == set(jres.params) == set(sres.params)
    for c, _, epochs in REQUESTS:
        assert vres.losses[c].shape == (epochs,)
        np.testing.assert_allclose(vres.losses[c], jres.losses[c], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(vres.losses[c], sres.losses[c], rtol=TOL, atol=TOL)
        _assert_tree_close(jres.params[c], vres.params[c])
        _assert_tree_close(params_to_numpy(sres.params[c]), vres.params[c])
    # epochs = 0 passes its init through untouched
    assert vres.params[6] is (treqs[6].init_params if stacked else tgp)


@pytest.mark.parametrize("stacked", [False, True], ids=["shared", "stacked"])
def test_parallel_local_train_equals_reference(mlp_task, fl_data, stacked):
    """The step itself, with and without shuffle orders, prox on."""
    import jax
    import jax.numpy as jnp

    jgp = _global(mlp_task, 1)
    k, bs, nb, epochs = 3, 8, 2, 2
    cap = bs * nb
    rng = np.random.default_rng(0)
    xs = rng.normal(size=(k, cap, 32)).astype(np.float32)
    ys = rng.integers(0, 10, size=(k, cap)).astype(np.int32)
    masks = (rng.random((k, cap)) < 0.8).astype(np.float32)
    perms = np.stack([np.stack([rng.permutation(cap) for _ in range(epochs)])
                      for _ in range(k)]).astype(np.int32)
    p0 = ({n: np.stack([np.asarray(v) + 0.01 * i for i in range(k)])
           for n, v in jgp.items()} if stacked else _np(jgp))
    jf = jax.jit(jclient.make_parallel_local_train(
        mlp_task, batch_size=bs, n_batches=nb, epochs=epochs, prox_mu=0.05,
        stacked_params=stacked))
    tf = tclient.make_parallel_local_train(
        tfl.MLPTask(dim=32, hidden=32), batch_size=bs, n_batches=nb,
        epochs=epochs, prox_mu=0.05, stacked_params=stacked)
    for perm in (perms, None):
        jargs = (jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(masks), jnp.asarray(0.1))
        jp, jl = (jf(p0, *jargs, jnp.asarray(perm)) if perm is not None
                  else jf(p0, *jargs))
        tp, tl = tf(params_from_numpy(p0, "cpu"), torch.as_tensor(xs),
                    torch.as_tensor(ys), torch.as_tensor(masks), 0.1,
                    None if perm is None else torch.as_tensor(perm))
        assert tuple(tl.shape) == (k, epochs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
        _assert_tree_close(jp, tp)


def test_vmapped_refuses_a_mesh():
    """The mesh is no longer refused: the executor keeps it and shards the
    client axis over its ``data`` axis (``tests/test_torch_mesh.py`` runs it
    on a host mesh and on two gloo ranks)."""
    mesh = object()
    assert tfl.VmappedExecutor(mesh=mesh).mesh is mesh
    assert tfl.VmappedExecutor().mesh is None
    assert "vmapped" in tfl.available_executors()


@pytest.mark.parametrize("policy_name", ["fedavg", "fedmarl"])
def test_two_rounds_same_cohorts_under_both_executors(fl_data, policy_name):
    runs = {}
    for executor in ("sequential", "vmapped"):
        cfg = tfl.FLConfig(n_devices=20, k_select=4, rounds=2, l_ep=2, lr=0.1,
                           seed=0, scenario="high-churn", executor=executor)
        srv = tfl.FLServer(cfg, tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data),
                           device="cpu")
        runs[executor] = (srv.run(tfl.build_policy(policy_name)), srv)
    (hs, ss), (hv, sv) = runs["sequential"], runs["vmapped"]
    assert len(hs) == len(hv) == 2
    for a, b in zip(hs, hv):
        np.testing.assert_array_equal(a.selected, b.selected)
        np.testing.assert_array_equal(a.probe_set, b.probe_set)
        np.testing.assert_array_equal(a.failed, b.failed)
        assert (a.r_t, a.r_e) == (b.r_t, b.r_e)
        assert abs(a.acc - b.acc) <= TOL
        assert (a.executor, b.executor) == ("sequential", "vmapped")
    _assert_tree_close(params_to_numpy(ss.global_params), sv.global_params)
    np.testing.assert_allclose(sv.last_loss, ss.last_loss, rtol=TOL, atol=TOL)


def test_async_dispatch_with_vmapped_inner(fl_data):
    def run(inner):
        cfg = tfl.FLConfig(n_devices=20, k_select=3, rounds=3, l_ep=2, lr=0.1,
                           seed=1, scenario="high-churn", executor="async",
                           async_concurrency=6, staleness="polynomial")
        srv = tfl.FLServer(cfg, tfl.MLPTask(dim=32, hidden=32), _tdata(fl_data),
                           executor=tfl.AsyncDispatchExecutor(inner=inner),
                           device="cpu")
        return srv.run(tfl.build_policy("fedavg")), srv

    (hs, ss), (hv, sv) = run("sequential"), run("vmapped")
    assert [r.executor for r in hv] == ["async[vmapped]"] * 3
    assert ([(r.selected.tolist(), r.cum_time, r.mean_staleness) for r in hs]
            == [(r.selected.tolist(), r.cum_time, r.mean_staleness) for r in hv])
    _assert_tree_close(params_to_numpy(ss.global_params), sv.global_params)
    assert jfl.executor_label(jfl.AsyncDispatchExecutor(inner="vmapped")) == \
        tfl.executor_label(tfl.AsyncDispatchExecutor(inner="vmapped"))
