"""select_topk in the port against the JAX reference, on the CPU.

The port's plain version (what its wrapper runs for CPU tensors, and what the
CUDA kernel is held to on the card) against ``repro``'s XLA oracle and the
Pallas kernel in interpret mode; the op contract; ``masked_topk``.

Tolerance: values within 1e-5 * max(1, |v|) (fp32 sums in another order).
Indices are exact, except at a place where the reference's score gap to a
neighbour is within twice that tolerance: such near-ties may come out in
either order.  Exact ties (masked rows, duplicated rows) still follow the
lowest-index rule exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.select_topk.ops as jops
from repro.kernels.select_topk.kernel import select_topk_pallas
from repro.kernels.select_topk.ref import select_topk_ref as jax_select_topk_ref
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.select_topk.kernel import k_padded, select_topk_cuda, select_topk_host
from repro_torch.kernels.select_topk.ops import masked_topk, select_topk, topk_indices
from repro_torch.kernels.select_topk.ref import NEG_INF, select_topk_ref

TOL = 1e-5


def _qnet(rng, f, h=64, zero=False):
    shapes = {"w1": (f, h), "b1": (h,), "w2": (h, h), "b2": (h,),
              "w3": (h, 1), "b3": (1,)}
    if zero:
        return {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    return {k: (rng.normal(size=s) * 0.3).astype(np.float32)
            for k, s in shapes.items()}


def _inputs(n, f, seed, masked_frac=0.3):
    rng = np.random.default_rng(seed)
    q = _qnet(rng, f)
    feats = rng.normal(size=(n, f)).astype(np.float32)
    mask = (rng.random(n) > masked_frac).astype(np.float32)
    bias = rng.normal(size=n).astype(np.float32)
    return q, feats, mask, bias


def _port(q, feats, mask, bias, k):
    v, i = select_topk_ref(params_from_numpy(q, "cpu"), torch.as_tensor(feats),
                           torch.as_tensor(mask), torch.as_tensor(bias), k=k)
    return v.numpy(), i.numpy()


def _assert_topk_matches(ref_v, ref_i, got_v, got_i, k):
    """ref_* hold the reference's full ordering (>= k entries)."""
    ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
    got_v, got_i = np.asarray(got_v)[:k], np.asarray(got_i)[:k]
    scale = np.maximum(1.0, np.abs(ref_v[:k]))
    assert np.all(np.abs(got_v - ref_v[:k]) <= TOL * scale), (got_v, ref_v[:k])
    # a place is exempt when the reference's gap to a neighbour (including
    # the first one below the cut) is a near-tie but not an exact sentinel tie
    gap = np.abs(np.diff(ref_v))
    sentinel = (ref_v[:-1] == NEG_INF) & (ref_v[1:] == NEG_INF)
    near = (gap <= 2 * TOL * np.maximum(1.0, np.abs(ref_v[1:]))) & ~sentinel
    exempt = np.zeros(len(ref_v), bool)
    exempt[:-1] |= near
    exempt[1:] |= near
    keep = ~exempt[:k]
    np.testing.assert_array_equal(got_i[keep], ref_i[:k][keep])
    assert len(set(got_i.tolist())) == k                  # no duplicates


def test_near_tie_exception_is_narrow():
    """The comparison tolerates a swap inside a near-tie and nothing else."""
    ref_v = np.array([3.0, 2.000001, 2.0, 1.0], np.float32)
    ref_i = np.array([10, 11, 12, 13])
    _assert_topk_matches(ref_v, ref_i, ref_v[[0, 2, 1]], ref_i[[0, 2, 1]], 3)
    with pytest.raises(AssertionError):       # 3.0 vs 2.0 is no near-tie
        _assert_topk_matches(ref_v, ref_i, ref_v[[0, 1, 2]], ref_i[[1, 0, 2]], 3)
    with pytest.raises(AssertionError):       # exact sentinel ties stay exact
        neg = np.full(3, NEG_INF, np.float32)
        _assert_topk_matches(neg, np.arange(3), neg, np.array([1, 0, 2]), 3)


CASES = [(1, 6, 1), (5, 6, 1), (5, 14, 5), (127, 6, 8), (127, 14, 40),
         (513, 6, 64), (513, 14, 8), (1000, 6, 40), (1000, 14, 64),
         (1000, 6, 1)]


@pytest.mark.parametrize("n,f,k", CASES)
def test_plain_matches_xla_oracle(n, f, k):
    q, feats, mask, bias = _inputs(n, f, seed=n * 31 + f + k)
    rv, ri = jax_select_topk_ref(q, jnp.asarray(feats), jnp.asarray(mask),
                                 jnp.asarray(bias), k=n)
    gv, gi = _port(q, feats, mask, bias, k)
    _assert_topk_matches(rv, ri, gv, gi, k)


@pytest.mark.parametrize("n,f,k", [(5, 6, 3), (127, 14, 40), (513, 6, 64)])
def test_plain_matches_pallas_interpret(n, f, k):
    q, feats, mask, bias = _inputs(n, f, seed=n + 5)
    pv, pi = select_topk_pallas(q, jnp.asarray(feats), jnp.asarray(mask),
                                jnp.asarray(bias), k=min(n, k + 1), block=64,
                                interpret=True)
    gv, gi = _port(q, feats, mask, bias, k)
    _assert_topk_matches(pv[:min(n, k + 1)], pi[:min(n, k + 1)], gv, gi, k)


def test_plain_all_masked():
    q, feats, _, bias = _inputs(40, 6, seed=0)
    mask = np.zeros(40, np.float32)
    rv, ri = jax_select_topk_ref(q, jnp.asarray(feats), jnp.asarray(mask),
                                 jnp.asarray(bias), k=5)
    gv, gi = _port(q, feats, mask, bias, 5)
    np.testing.assert_array_equal(gi, np.asarray(ri))
    np.testing.assert_array_equal(gi, np.arange(5))
    assert np.all(gv == NEG_INF)


def test_plain_duplicate_rows_tie_to_lowest_index():
    """Rows duplicated many times score exactly alike: every tie group must
    come out in ascending index order, exactly as the reference orders it."""
    rng = np.random.default_rng(6)
    q = _qnet(rng, 6)
    base = rng.normal(size=(12, 6)).astype(np.float32)
    pick = rng.integers(0, 12, size=300)
    feats = base[pick]
    mask = (rng.random(300) > 0.2).astype(np.float32)
    bias = np.zeros(300, np.float32)
    rv, ri = jax_select_topk_ref(q, jnp.asarray(feats), jnp.asarray(mask),
                                 jnp.asarray(bias), k=64)
    gv, gi = _port(q, feats, mask, bias, 64)
    np.testing.assert_array_equal(gi, np.asarray(ri))
    for g in np.unique(pick[gi]):
        members = gi[pick[gi] == g]
        assert np.all(np.diff(members) > 0)


def test_plain_quantized_scores_exact():
    """A zeroed net with integer biases scores exactly: indices and values
    equal the reference's, ties by lowest index."""
    rng = np.random.default_rng(2)
    q = _qnet(rng, 6, zero=True)
    feats = rng.normal(size=(500, 6)).astype(np.float32)
    bias = rng.integers(0, 4, size=500).astype(np.float32)
    mask = (rng.random(500) > 0.2).astype(np.float32)
    rv, ri = jax_select_topk_ref(q, jnp.asarray(feats), jnp.asarray(mask),
                                 jnp.asarray(bias), k=32)
    gv, gi = _port(q, feats, mask, bias, 32)
    np.testing.assert_array_equal(gi, np.asarray(ri))
    np.testing.assert_array_equal(gv, np.asarray(rv))


# ---------------------------------------------------------------------------
# the wrapper's device rule
# ---------------------------------------------------------------------------


def test_wrapper_cpu_takes_plain_version_without_counting():
    q, feats, mask, bias = _inputs(50, 6, seed=1)
    params = params_from_numpy(q, "cpu")
    before = select_topk_cuda.launches
    v, i = select_topk_cuda(params, torch.as_tensor(feats), torch.as_tensor(mask),
                            torch.as_tensor(bias), k=7)
    rv, ri = _port(q, feats, mask, bias, 7)
    np.testing.assert_array_equal(i.numpy(), ri)
    np.testing.assert_array_equal(v.numpy(), rv)
    assert select_topk_cuda.launches == before


def test_wrapper_other_devices_raise():
    """Only a CPU tensor may take the plain version: any other device
    launches the kernel or raises (here a meta tensor, which has no data)."""
    q = {k: torch.empty(v.shape, device="meta")
         for k, v in _qnet(np.random.default_rng(0), 6).items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        select_topk_cuda(q, torch.empty(10, 6, device="meta"),
                         torch.empty(10, device="meta"),
                         torch.empty(10, device="meta"), k=3)


def test_host_entry_cpu_takes_plain_version_without_counting():
    """The one-call host entry on CPU parameters: the plain version on the
    packed records, exactly; None mask and bias mean all valid and zeros."""
    q, feats, mask, bias = _inputs(60, 6, seed=3)
    params = params_from_numpy(q, "cpu")
    before = select_topk_cuda.launches
    v, i = select_topk_host(params, feats.astype(np.float64), mask > 0, bias, k=9)
    rv, ri = _port(q, feats, mask, bias, 9)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(v, rv)
    assert i.dtype == np.int64 and v.dtype == np.float32
    v, i = select_topk_host(params, feats, None, None, k=60)
    rv, ri = _port(q, feats, np.ones(60, np.float32), np.zeros(60, np.float32), 60)
    np.testing.assert_array_equal(i, ri)
    np.testing.assert_array_equal(v, rv)
    assert select_topk_cuda.launches == before


def test_host_entry_other_devices_raise():
    q = {k: torch.empty(v.shape, device="meta")
         for k, v in _qnet(np.random.default_rng(0), 6).items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        select_topk_host(q, np.zeros((10, 6)), None, None, k=3)


def test_op_takes_parameters_that_require_grad():
    """The Q-net under training: its parameters require grad; the op's
    result is plain host arrays all the same."""
    rng = np.random.default_rng(11)
    q = _qnet(rng, 6)
    params = {k: v.requires_grad_(True) for k, v in params_from_numpy(q, "cpu").items()}
    states = rng.normal(size=(40, 6))
    idx, vals = select_topk(params, states, None, 5)
    rv, ri = _port(q, states.astype(np.float32), np.ones(40, np.float32),
                   np.zeros(40, np.float32), 5)
    np.testing.assert_array_equal(idx, ri)
    np.testing.assert_array_equal(vals, rv)


def test_k_padded():
    assert [k_padded(k) for k in (1, 8, 9, 40, 64, 1000)] == [8, 8, 16, 40, 64, 1000]


# ---------------------------------------------------------------------------
# the shared op contract (as the reference's tests/test_select_topk.py pins)
# ---------------------------------------------------------------------------


def _cpu_params(seed, f):
    return params_from_numpy(_qnet(np.random.default_rng(seed), f), "cpu")


def test_op_masked_candidates_excluded():
    rng = np.random.default_rng(4)
    params = _cpu_params(4, 6)
    states = rng.normal(size=(50, 6))
    mask = np.ones(50)
    mask[::2] = 0.0                               # mask the evens
    idx, _ = select_topk(params, states, mask, 10)
    assert len(idx) == 10
    assert np.all(idx % 2 == 1)
    idx2, _ = select_topk(lambda s: s[:, 0], states, mask, 10)
    assert np.all(idx2 % 2 == 1)


def test_op_k_exceeds_n_valid():
    rng = np.random.default_rng(5)
    params = _cpu_params(5, 6)
    states = rng.normal(size=(10, 6))
    mask = np.zeros(10)
    mask[[2, 7, 9]] = 1.0
    idx, vals = select_topk(params, states, mask, 8)
    assert sorted(idx.tolist()) == [2, 7, 9]
    assert len(vals) == 3
    idx, vals = select_topk(params, states, np.zeros(10), 8)
    assert len(idx) == 0 and len(vals) == 0


def test_op_scores_descending_and_reported():
    s = np.random.default_rng(6).normal(size=200)
    idx, vals = select_topk(None, s, None, 30)
    assert np.all(np.diff(vals) <= 0)
    np.testing.assert_allclose(vals, s[idx])


def test_op_matches_reference_op():
    """The fused mode of the port's op against the reference op, bias and
    mask included; the host modes are numpy copies and must be equal."""
    rng = np.random.default_rng(7)
    q = _qnet(rng, 8)
    states = rng.normal(size=(333, 8))
    mask = (rng.random(333) > 0.25).astype(float)
    bias = rng.normal(size=333)
    ri, rv = jops.select_topk({k: jnp.asarray(v) for k, v in q.items()},
                              states, mask, 333, bias=bias, impl="xla")
    gi, gv = select_topk(params_from_numpy(q, "cpu"), states, mask, 40, bias=bias)
    _assert_topk_matches(rv, ri, gv, gi, 40)
    for fn in (None, lambda s: s[:, 1] - s[:, 2]):
        st = states[:, 0] if fn is None else states
        ri, rv = jops.select_topk(fn, st, mask, 40, bias=bias)
        gi, gv = select_topk(fn, st, mask, 40, bias=bias)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gv, rv)


@pytest.mark.parametrize("k", [1, 10, 64, 999, 1000])
def test_topk_indices_equals_stable_argsort(k):
    s = np.round(np.random.default_rng(8).normal(size=1000), 1)   # many ties
    np.testing.assert_array_equal(topk_indices(s, k),
                                  np.argsort(-s, kind="stable")[:k])


def test_topk_indices_masked():
    rng = np.random.default_rng(9)
    s = rng.normal(size=100)
    mask = rng.random(100) > 0.5
    got = topk_indices(s, 20, mask)
    want = np.argsort(-np.where(mask, s, -np.inf), kind="stable")[:20]
    np.testing.assert_array_equal(got, want)
    assert np.all(mask[got])


# ---------------------------------------------------------------------------
# masked_topk (the double-Q bootstrap's selection)
# ---------------------------------------------------------------------------


def test_masked_topk_ties_and_mask():
    s = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, 0.0])
    m = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
    vals, idx = masked_topk(s, m, 3)
    np.testing.assert_array_equal(idx.numpy(), [1, 4, 3])   # 2 is masked
    np.testing.assert_array_equal(vals.numpy(), [3.0, 3.0, 2.0])


@pytest.mark.parametrize("m_valid,k", [(64, 10), (7, 10), (0, 4)])
def test_masked_topk_matches_reference(m_valid, k):
    rng = np.random.default_rng(m_valid + k)
    s = np.round(rng.normal(size=64), 1).astype(np.float32)   # with ties
    mask = np.zeros(64, np.float32)
    mask[rng.permutation(64)[:m_valid]] = 1.0
    rv, ri = jops.masked_topk(jnp.asarray(s), jnp.asarray(mask), k)
    gv, gi = masked_topk(torch.as_tensor(s), torch.as_tensor(mask), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    # batched over a leading dim, as the train step uses it
    bv, bi = masked_topk(torch.as_tensor(np.stack([s, s])),
                         torch.as_tensor(np.stack([mask, mask])), k)
    np.testing.assert_array_equal(bi.numpy(), np.stack([gi.numpy()] * 2))
