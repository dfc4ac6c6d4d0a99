"""An LM as the FL global model: the port's ``LMTask`` against the reference.

The reference's one-round LM test (``tests/test_fl.py::test_lm_task_fl_round``:
yi-6b smoke, fp32, sequences of 16 tokens, 8 devices, k=2, one local epoch)
runs in both packages on the same numpy token stream.  The port starts from
the reference's init (``params_from_numpy``), so the round must give the same
cohort exactly and the same global params within 1e-5, under the sequential
and the vmapped executor, and once under FedRank with the reference's Q-net;
with ``remat=True`` on both sides the vmapped round of the yi-6b,
hymba-1.5b, rwkv6-3b and olmoe-1b-7b smoke models too.
The task's own pieces (the per-token mask, loss, accuracy, cost model) are
held to the reference on one batch.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.fl as jfl
from repro.configs import get_model_config as jget_config
from repro.data.loader import FederatedData as JFederatedData
from repro.data.synthetic import SyntheticClassificationDataset, make_lm_stream

import repro_torch.data as tdata
import repro_torch.fl as tfl
from repro_torch.configs import get_model_config
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl._tree import tree_leaves
from repro_torch.models import transformer as T

TOL = 1e-5
SEQ = 16


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cpu(tree):
    return params_from_numpy(_np(tree), "cpu")


def _assert_tree_close(ref, got, tol=TOL):
    ref_leaves = jax.tree.leaves(_np(ref))
    got_leaves = tree_leaves(params_to_numpy(got))
    assert len(ref_leaves) == len(got_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        assert r.shape == g.shape and r.dtype == g.dtype
        np.testing.assert_allclose(g, r, rtol=tol, atol=tol)


def _lm_data(vocab):
    """The reference test's data: a token stream cut into (x, y) sequences
    of SEQ, 8 strided client shards, the first 32 sequences as the test set."""
    stream = make_lm_stream(n_tokens=4000, vocab=vocab, seed=0)
    n_seq = len(stream) // (SEQ + 1)
    x = np.stack([stream[i * (SEQ + 1):(i + 1) * (SEQ + 1) - 1] for i in range(n_seq)])
    y = np.stack([stream[i * (SEQ + 1) + 1:(i + 1) * (SEQ + 1)] for i in range(n_seq)])
    train = SyntheticClassificationDataset(x, y[:, 0], 10)
    train.x, train.y = x, y
    test = SyntheticClassificationDataset(x[:32], y[:32, 0], 10)
    test.x, test.y = x[:32], y[:32]
    parts = [np.arange(i, n_seq, 8) for i in range(8)]
    return train, test, parts


def _servers(executor="sequential", arch="yi-6b", remat=False, **kw):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), remat=remat)
    tcfg = dataclasses.replace(get_model_config(arch, smoke=True), remat=remat)
    train, test, parts = _lm_data(jcfg.vocab_size)
    fl_kw = dict(n_devices=8, k_select=2, rounds=1, l_ep=1, lr=0.3, seed=0, **kw)
    jsrv = jfl.FLServer(jfl.FLConfig(executor=executor, **fl_kw),
                        jfl.LMTask(jcfg, seq_len=SEQ), JFederatedData(train, test, parts))
    tsrv = tfl.FLServer(tfl.FLConfig(executor=executor, **fl_kw),
                        tfl.LMTask(tcfg, seq_len=SEQ),
                        tdata.FederatedData(train, test, parts), device="cpu")
    tsrv.global_params = _cpu(jsrv.global_params)
    tsrv._last_acc = jsrv._last_acc
    return jsrv, tsrv


def _assert_round_matches(jr, tr):
    np.testing.assert_array_equal(tr.probe_set, jr.probe_set)
    np.testing.assert_array_equal(tr.selected, jr.selected)
    np.testing.assert_array_equal(tr.failed, jr.failed)
    assert (tr.r_t, tr.r_e) == (jr.r_t, jr.r_e)
    assert np.isfinite(tr.test_loss) and tr.r_t > 0
    np.testing.assert_allclose(tr.test_loss, jr.test_loss, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tr.acc, jr.acc, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("executor,arch,remat", [
    pytest.param("sequential", "yi-6b", False, id="sequential"),
    pytest.param("vmapped", "yi-6b", False, id="vmapped"),
    *(pytest.param("vmapped", arch, True, id=f"vmapped-remat-{arch}")
      for arch in ("yi-6b", "hymba-1.5b", "rwkv6-3b", "olmoe-1b-7b")),
])
def test_lm_fl_round_equals_reference(executor, arch, remat):
    """``remat=True`` on both sides: the reference's ``jax.checkpoint``
    under ``jax.vmap``, the port's layer checkpoint under ``torch.func``."""
    jsrv, tsrv = _servers(executor, arch, remat)
    jr, = jsrv.run(jcore.RandomPolicy())
    applied = T._checkpoint_layer.applied
    tr, = tsrv.run(tfl.build_policy("fedavg"))
    assert (T._checkpoint_layer.applied > applied) == remat
    _assert_round_matches(jr, tr)
    assert tr.executor == executor
    _assert_tree_close(jsrv.global_params, tsrv.global_params)
    np.testing.assert_allclose(tsrv.last_loss, jsrv.last_loss, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("executor", ["sequential", "vmapped"])
def test_moe_lm_fl_round_equals_reference(executor):
    """olmoe-1b-7b (smoke) as the global model: each client's loss carries
    the router losses, and the vmapped executor routes every client's
    tokens under ``vmap(grad(...))``."""
    jsrv, tsrv = _servers(executor, arch="olmoe-1b-7b")
    jr, = jsrv.run(jcore.RandomPolicy())
    tr, = tsrv.run(tfl.build_policy("fedavg"))
    _assert_round_matches(jr, tr)
    _assert_tree_close(jsrv.global_params, tsrv.global_params)


def test_lm_fl_fedrank_round_equals_reference():
    jsrv, tsrv = _servers("sequential")
    jpol = jcore.FedRankPolicy(None, k=2, seed=0, train_batch=4,
                               train_steps_per_round=1)
    tpol = tfl.build_policy("fedrank", qnet=_cpu(jpol.q), k=2, seed=0,
                            train_batch=4, train_steps_per_round=1)
    jr, tr = jsrv.run_round(jpol), tsrv.run_round(tpol)
    _assert_round_matches(jr, tr)
    assert len(tr.probe_set) > len(tr.selected)
    _assert_tree_close(jsrv.global_params, tsrv.global_params)


def test_executors_agree_on_an_lm_round():
    """The vmapped executor over the nested LM tree gives the sequential
    one's cohort and params, FedProx included."""
    runs = []
    for executor in ("sequential", "vmapped"):
        _, tsrv = _servers(executor, prox_mu=0.1)
        runs.append((tsrv.run(tfl.build_policy("fedavg"))[0], tsrv))
    (rs, ss), (rv, sv) = runs
    np.testing.assert_array_equal(rs.selected, rv.selected)
    for a, b in zip(tree_leaves(ss.global_params), tree_leaves(sv.global_params)):
        torch.testing.assert_close(b, a, rtol=TOL, atol=TOL)


def test_lm_task_pieces_equal_reference():
    jcfg, tcfg = jget_config("yi-6b", smoke=True), get_model_config("yi-6b", smoke=True)
    jtask, ttask = jfl.LMTask(jcfg, seq_len=SEQ), tfl.LMTask(tcfg, seq_len=SEQ)
    jp = jtask.init(jax.random.PRNGKey(0))
    tp = _cpu(jp)
    train, _, _ = _lm_data(jcfg.vocab_size)
    x, y = train.x[:4], train.y[:4]
    mask = np.array([1, 1, 0, 1], np.float32)
    jb = {"x": x, "y": y, "mask": mask}
    tb = {"x": torch.as_tensor(x), "y": torch.as_tensor(y), "mask": torch.as_tensor(mask)}
    for fn in ("loss", "accuracy"):
        np.testing.assert_allclose(float(getattr(ttask, fn)(tp, tb)),
                                   float(getattr(jtask, fn)(jp, jb)), rtol=TOL, atol=TOL)
    tb.pop("mask")
    jb.pop("mask")
    np.testing.assert_allclose(float(ttask.loss(tp, tb)), float(jtask.loss(jp, jb)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(
        ttask._seq_mask(torch.as_tensor(mask), torch.as_tensor(y)).numpy(),
        np.asarray(jtask._seq_mask(mask, y)))
    assert ttask._seq_mask(None, torch.as_tensor(y)) is None
    assert ttask.flops_per_sample() == jtask.flops_per_sample()
    assert ttask.param_bytes() == jtask.param_bytes()
    fresh = ttask.init(0, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(fresh)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]


def test_large_leaves_step_client_by_client(monkeypatch):
    """The vmapped executor's update on the CPU (the plain version of
    ``repro_torch::sgd_update``) steps a leaf past ``STACKED_STEP_CHUNK``
    elements one client at a time into a contiguous leaf: with every leaf
    taking that route, a two-step round gives the same cohort and its
    params within 1e-5 (the same values per step; a contiguous leaf may take
    another GEMM path in the next step), and the losses of the first step
    the same bits."""
    from repro_torch.kernels.sgd_update import ref as sgd_ref

    runs = []
    for chunk in (sgd_ref.STACKED_STEP_CHUNK, 0):
        monkeypatch.setattr(sgd_ref, "STACKED_STEP_CHUNK", chunk)
        _, tsrv = _servers("vmapped", local_batch=8)
        runs.append((tsrv.run(tfl.build_policy("fedavg"))[0], tsrv))
    (ra, sa), (rb, sb) = runs
    np.testing.assert_array_equal(ra.selected, rb.selected)
    for a, b in zip(tree_leaves(sa.global_params), tree_leaves(sb.global_params)):
        torch.testing.assert_close(b, a, rtol=TOL, atol=TOL)
