"""Nested parameter trees through the port's FL layer, against the reference.

The reference's reducers and attacks are pytree-generic (``jax.tree.map``,
``jax.tree.leaves``); the port's walk nested dicts through
``repro_torch.fl._tree`` in the reference's leaf order (dict keys sorted,
recursively).  Held here on the yi-6b smoke LM's tree
(``{"embed", "final_norm", "layers": {...}, "lm_head"}``), drawn by the
reference and fed to both packages:

* ``fedavg`` of nested trees runs (before the tree walk it raised
  ``AttributeError: 'dict' object has no attribute 'float'``) and equals the
  reference within 1e-6, in fp32 and with bf16 leaves (accumulated in fp32,
  cast back);
* every reducer, the buffered (staleness-weighted, plain and robust) and the
  delta (FedOpt) merges within 1e-6 of ``repro.fl.aggregation``;
* ``GaussianNoise`` draws bit for bit the reference's noise, ``SignFlip`` and
  ``ScaledUpdate`` map deltas leaf by leaf, and ``LabelSkewDrift`` rolls
  ``lm_head``'s vocabulary axis (the last leaf in sorted order);
* ``tree_leaves`` visits leaves in ``jax.tree.leaves`` order, and the stack,
  index and unflatten helpers round-trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl.aggregation as jagg
import repro.fl.attacks as jatt
from repro.configs import get_model_config as jget_config
from repro.models import transformer as JT

import repro_torch.fl.aggregation as tagg
import repro_torch.fl.attacks as tatt
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.fl._tree import (
    tree_index,
    tree_iter,
    tree_leaves,
    tree_map,
    tree_stack,
    tree_unflatten,
)

TOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _lm_trees(m=5, dtype=jnp.float32):
    """``m`` yi-6b smoke LM trees: the reference's init, perturbed per client
    so every coordinate differs (numpy draws)."""
    cfg = jget_config("yi-6b", smoke=True)
    base = _np(JT.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(1)
    trees = [jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)
                                     ).astype(np.float32), base)
             for _ in range(m)]
    if dtype != jnp.float32:
        trees = [jax.tree.map(lambda a: np.asarray(jnp.asarray(a, dtype)), t)
                 for t in trees]
    return trees


def _port(tree):
    return params_from_numpy(tree, "cpu")


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _assert_tree_close(ref, got, tol=TOL, atol=None):
    ref_leaves = jax.tree.leaves(_np(ref))
    got_leaves = tree_leaves(params_to_numpy(got))
    assert len(ref_leaves) == len(got_leaves)
    for r, g in zip(ref_leaves, got_leaves):
        assert r.shape == g.shape and r.dtype == g.dtype, (r.shape, g.shape)
        np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64),
                                   rtol=tol, atol=tol if atol is None else atol)


WEIGHTS = [40.0, 25.0, 120.0, 64.0, 9.0]


def test_tree_leaves_order_equals_jax():
    trees = _lm_trees(1)
    ref = jax.tree.leaves(trees[0])
    got = tree_leaves(_port(trees[0]))
    assert len(got) == len(ref) > 6
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), r)
    # lists and tuples in order, dicts sorted at every depth
    mixed = {"z": [np.float32(1), (np.float32(2), np.float32(3))],
             "a": {"y": np.float32(4), "b": np.float32(5)}}
    assert tree_leaves(mixed) == jax.tree.leaves(mixed) == [5, 4, 1, 2, 3]
    assert list(tree_iter(mixed)) == [1, 2, 3, 4, 5]      # storage order


def test_tree_helpers_round_trip():
    tree = _port(_lm_trees(1)[0])
    leaves = tree_leaves(tree)
    back = tree_unflatten(tree, [leaf + 1 for leaf in leaves])
    assert list(back) == list(tree) and list(back["layers"]) == list(tree["layers"])
    for a, b in zip(tree_leaves(back), leaves):
        assert torch.equal(a, b + 1)
    stacked = tree_stack([tree, back])
    for j, want in enumerate((tree, back)):
        for a, b in zip(tree_leaves(tree_index(stacked, j)), tree_leaves(want)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="more leaves"):
        tree_unflatten(tree, leaves + [leaves[0]])
    doubled = tree_map(lambda a, b: a + b, tree, tree)
    for a, b in zip(tree_leaves(doubled), leaves):
        assert torch.equal(a, 2 * b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fedavg_of_nested_lm_trees(dtype):
    """The fault this tree walk repairs: ``fedavg`` of two nested LM trees
    raised on flat-dict code.  Now it equals the reference, leaves kept in
    their dtype (bf16 accumulates in fp32 and is cast back once)."""
    trees = _lm_trees(2, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    ref = jagg.fedavg([_jax(t) for t in trees], WEIGHTS[:2])
    got = tagg.fedavg([_port(t) for t in trees], WEIGHTS[:2])
    if dtype == "float32":
        _assert_tree_close(ref, got)
    else:   # one bf16 rounding of the same fp32 sum: at most one bf16 ulp apart
        _assert_tree_close(ref, got, 2.0 ** -7, atol=0.0)


@pytest.mark.parametrize("kind", ["mean", "trimmed_mean", "coordinate_median",
                                  "krum", "multi_krum"])
@pytest.mark.parametrize("m", [4, 5])
def test_robust_reducers_on_nested_trees(kind, m):
    trees = _lm_trees(m)
    ref = jagg.robust_aggregate([_jax(t) for t in trees], WEIGHTS[:m], kind=kind,
                                trim=1, f=1)
    got = tagg.robust_aggregate([_port(t) for t in trees], WEIGHTS[:m], kind=kind,
                                trim=1, f=1)
    _assert_tree_close(ref, got)


def test_krum_scores_on_nested_trees():
    trees = _lm_trees(5)
    trees[3] = jax.tree.map(lambda a: a + 3.0, trees[3])      # an outlier
    ref = jagg.krum_scores([_jax(t) for t in trees], f=1)
    got = tagg.krum_scores([_port(t) for t in trees], f=1)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert int(np.argmax(got)) == 3


@pytest.mark.parametrize("kind,robust", [("polynomial", "mean"),
                                         ("hinge", "mean"),
                                         ("constant", "mean"),
                                         ("polynomial", "trimmed_mean"),
                                         ("constant", "coordinate_median")])
def test_buffered_merge_on_nested_trees(kind, robust):
    trees = _lm_trees(5)
    g, buf = trees[0], trees[1:]
    lags = [0, 3, 7, 1]
    ref = jagg.buffered_aggregate(_jax(g), [_jax(t) for t in buf], WEIGHTS[:4], lags,
                                  kind=kind, a=0.5, b=2, robust=robust)
    got = tagg.buffered_aggregate(_port(g), [_port(t) for t in buf], WEIGHTS[:4], lags,
                                  kind=kind, a=0.5, b=2, robust=robust)
    _assert_tree_close(ref, got)


@pytest.mark.parametrize("server_lr", [1.0, 0.5])
def test_delta_merge_on_nested_trees(server_lr):
    trees = _lm_trees(4)
    g, clients = trees[0], trees[1:]
    ref = jagg.weighted_delta_aggregate(_jax(g), [_jax(t) for t in clients],
                                        WEIGHTS[:3], server_lr=server_lr)
    got = tagg.weighted_delta_aggregate(_port(g), [_port(t) for t in clients],
                                        WEIGHTS[:3], server_lr=server_lr)
    _assert_tree_close(ref, got)


def test_gaussian_noise_draws_equal_reference_bit_for_bit():
    p, g = _lm_trees(2)
    ref = jatt.GaussianNoise(fraction=0.5, sigma=0.3).corrupt(
        _jax(p), _jax(g), cid=3, seed=7, round_idx=2)
    got = tatt.GaussianNoise(fraction=0.5, sigma=0.3).corrupt(
        _port(p), _port(g), cid=3, seed=7, round_idx=2)
    for r, t in zip(jax.tree.leaves(_np(ref)), tree_leaves(params_to_numpy(got))):
        np.testing.assert_array_equal(t, r)


@pytest.mark.parametrize("attack", [("SignFlip", {"scale": 4.0}),
                                    ("ScaledUpdate", {"factor": 10.0})])
def test_delta_attacks_on_nested_trees(attack):
    name, kw = attack
    p, g = _lm_trees(2)
    ref = getattr(jatt, name)(fraction=0.5, **kw).corrupt(
        _jax(p), _jax(g), cid=1, seed=0, round_idx=0)
    got = getattr(tatt, name)(fraction=0.5, **kw).corrupt(
        _port(p), _port(g), cid=1, seed=0, round_idx=0)
    _assert_tree_close(ref, got)


@pytest.mark.parametrize("round_idx", [0, 1, 5])
def test_label_skew_drift_rolls_the_lm_heads_vocabulary(round_idx):
    p, g = _lm_trees(2)
    attack = dict(fraction=0.5, period=1)
    ref = jatt.LabelSkewDrift(**attack).corrupt(_jax(p), _jax(g), cid=0, seed=0,
                                                round_idx=round_idx)
    got = tatt.LabelSkewDrift(**attack).corrupt(_port(p), _port(g), cid=0, seed=0,
                                                round_idx=round_idx)
    _assert_tree_close(ref, got)
    vocab = p["lm_head"].shape[-1]
    assert tree_leaves(_port(p))[-1].shape[-1] == vocab
    delta = p["lm_head"] - g["lm_head"]
    want = g["lm_head"] + np.roll(delta, round_idx % vocab, axis=-1)
    np.testing.assert_allclose(got["lm_head"].numpy(), want, rtol=1e-6, atol=1e-6)
    # leaves without the vocabulary as their last axis pass through
    for want, leaf in zip(jax.tree.leaves(p), tree_leaves(got)):
        if want.shape[-1] != vocab:
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-6, atol=1e-6)
