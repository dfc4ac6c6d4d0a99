"""DeepSeek-V2-Lite in the port (``configs/deepseek_v2_lite.py``: MLA with
YaRN, a dense first layer, shared experts, unrenormalised gates, the
sequence-level balance loss, a layer holding a share of its experts) held
to the plain reference ``models/deepseek_v2_ref.py``, fp32 on the CPU at
the smoke size with seeded random weights.

Tolerances, each with its reason:

* ``FWD_TOL`` 2e-5 of the largest logit: the port and the reference compute
  the same fp32 products in other orders (the port sums q.k as nope + rope
  parts, scatters nothing, combines the k choices by a gather), so they
  differ by fp32 round-off, about 1e-6 here; a bf16 product rounds its
  inputs to 8 bits of mantissa, about 4e-3 relative, and breaks it;
* ``GRAD_TOL`` 1e-4 of each leaf's largest gradient: the backward adds one
  more pass of the same round-off;
* YaRN's frequencies and the softmax scale are the same fp32 operations on
  both sides: equal to 1e-7 relative.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_model_config, list_archs, port_archs
from repro_torch.data import FederatedData, SyntheticClassificationDataset, make_lm_stream
from repro_torch.fl import FLConfig, FLServer, LMTask, build_policy
from repro_torch.fl import client as fl_client
from repro_torch.kernels.sgd_update.kernel import _client_block_contiguous
from repro_torch.models import attention as attn
from repro_torch.models import deepseek_v2_ref as R
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as T
from repro_torch.obs import RunRecorder
from repro_torch.obs.profiling import clear_profiler, set_profiler

FWD_TOL = 2e-5
GRAD_TOL = 1e-4
JAX_ARCHS = ["gemma-7b", "h2o-danube-3-4b", "hymba-1.5b", "internvl2-76b", "minitron-4b",
             "olmoe-1b-7b", "phi3.5-moe-42b-a6.6b", "rwkv6-3b", "whisper-medium", "yi-6b"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(**moe):
    cfg = get_model_config("deepseek-v2-lite", smoke=True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe)) if moe else cfg


def _tokens(cfg, b=2, s=16, seed=1):
    return torch.randint(0, cfg.vocab_size, (b, s + 1), generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def test_registry_resolves_the_port_only_model():
    assert list_archs() == JAX_ARCHS and "deepseek-v2-lite" not in list_archs()
    assert port_archs() == ["deepseek-v2-lite"]
    cfg = get_model_config("deepseek-v2-lite")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_lora_rank, cfg.qk_head_dim,
            cfg.v_head_dim, cfg.first_k_dense, cfg.d_ff_dense, cfg.vocab_size) == (
        27, 2048, 16, 512, 192, 128, 1, 10944, 102400)
    m = cfg.moe
    assert (m.n_experts, m.top_k, m.d_ff_expert, m.n_shared_experts, m.d_ff_shared, m.held,
            m.norm_topk_prob, m.seq_aux, m.router_z_coef) == (64, 6, 1408, 2, 2816, 64, False,
                                                              True, 0.0)
    smoke = get_model_config("deepseek-v2-lite", smoke=True)
    assert smoke.attention == "mla" and smoke.first_k_dense == 1 and smoke.n_layers == 3
    assert smoke.moe.held < smoke.moe.n_experts and smoke.moe.n_shared_experts == 2


def test_param_counts_of_the_benchmark_cut():
    """5 layers, 8 of 64 experts held: every leaf counted by hand."""
    cfg = get_model_config("deepseek-v2-lite")
    cut = dataclasses.replace(cfg, n_layers=5, moe=dataclasses.replace(cfg.moe, experts_held=8))
    d = 2048
    mla = d * 16 * 192 + d * 576 + 512 + 512 * 16 * 256 + 16 * 128 * d
    assert mla == 13_763_072 == cut.mla_params()
    dense = mla + 3 * d * 10944 + 2 * d
    expert_layer = mla + d * 64 + 3 * d * 2816 + 8 * 3 * d * 1408 + 2 * d
    total = 2 * 102400 * d + d + dense + 4 * expert_layer
    assert cut.param_count() == total == 902_062_592
    assert cut.active_param_count() == total - 4 * (8 - 0.75) * 3 * d * 1408
    p = T.init_params(0, get_model_config("deepseek-v2-lite", smoke=True), "cpu")
    n = sum(t.numel() for t in torch.utils._pytree.tree_leaves(p))
    assert n == get_model_config("deepseek-v2-lite", smoke=True).param_count()


def test_yarn_frequencies_and_softmax_scale():
    cfg = get_model_config("deepseek-v2-lite")
    inv, cs = attn.yarn_freqs(cfg)
    want_cos, _ = R.yarn(R.dims_of(cfg), 2, "cpu")
    assert cs == 1.0
    # position 1's angle is the frequency itself
    assert torch.allclose(torch.cos(inv), want_cos[1], rtol=1e-7, atol=0)
    extra = 1.0 / (10000.0 ** (torch.arange(0, 64, 2, dtype=torch.float32) / 64))
    # beta_fast 32 and beta_slow 1 at 4096 positions: dims below 10 keep
    # their frequency, from 23 on it is divided by the factor 40
    assert torch.equal(inv[:11], extra[:11])
    assert torch.allclose(inv[23:], extra[23:] / 40, rtol=1e-6, atol=0)
    assert bool((inv[11:23] < extra[11:23]).all() and (inv[11:23] > extra[11:23] / 40).all())
    m = 0.1 * 0.707 * math.log(40) + 1
    assert abs(m - 1.2608) < 1e-4
    assert attn.mla_softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m, rel=1e-7)
    assert attn.mla_softmax_scale(cfg) == pytest.approx(R.softmax_scale(R.dims_of(cfg)), rel=1e-7)


def test_mla_block_matches_the_reference():
    cfg = _smoke()
    p = T.init_params(0, cfg, "cpu")
    lp = T.layer_params(p["layers"], 0)["attn"]
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(2))
    got = attn.mla_prefill(lp, x, cfg)
    want = R.mla(R.dims_of(cfg), lp, x)
    assert _rel(got, want) <= FWD_TOL
    with pytest.raises(ValueError, match="naive route only"):
        attn.mla_prefill(lp, x, cfg, impl="blocked")


def test_mla_tables_made_inside_a_transform_are_plain_tensors():
    """The YaRN table and causal mask are cached per length: first asked for
    inside ``vmap(grad(...))`` they are still plain tensors, and a later
    call outside the transform gives the same result as a fresh table."""
    cfg = _smoke()
    p = T.init_params(0, cfg, "cpu")
    lp = T.layer_params(p["layers"], 0)["attn"]
    x = torch.randn(3, 2, 11, cfg.d_model, generator=torch.Generator().manual_seed(4))
    attn._mla_tables.cache_clear()
    torch.func.vmap(torch.func.grad(lambda xx: attn.mla_prefill(lp, xx, cfg).sum()))(x)
    cos, sin, causal = attn._mla_tables(cfg, 11, torch.device("cpu"))
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    assert not any(wrapped(t) for t in (cos, sin, causal))
    got = attn.mla_prefill(lp, x[0], cfg)
    attn._mla_tables.cache_clear()
    assert torch.equal(got, attn.mla_prefill(lp, x[0], cfg))


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_forward_logits_and_aux_match_the_reference(dispatch):
    cfg = _smoke(dispatch=dispatch, capacity_factor=1.0)      # some pairs dropped
    p = T.init_params(0, cfg, "cpu")
    tok = _tokens(cfg)[:, :-1]
    logits, aux = T.forward(p, cfg, tok)
    want, want_aux = R.forward(p, R.dims_of(cfg), tok)
    assert _rel(logits, want) <= FWD_TOL
    assert float(aux) == pytest.approx(float(want_aux), rel=FWD_TOL)
    assert float(aux) > 0


def _port_grads(cfg, p, tok):
    leaves, spec = torch.utils._pytree.tree_flatten(p)
    leaves = [t.detach().requires_grad_(True) for t in leaves]
    pp = torch.utils._pytree.tree_unflatten(leaves, spec)
    loss = LMTask(cfg).loss(pp, {"x": tok[:, :-1], "y": tok[:, 1:]})
    return loss, torch.autograd.grad(loss, leaves)


def _ref_grads(cfg, p, tok):
    leaves, spec = torch.utils._pytree.tree_flatten(p)
    leaves = [t.detach().float().requires_grad_(True) for t in leaves]
    pp = torch.utils._pytree.tree_unflatten(leaves, spec)
    loss = R.loss(pp, R.dims_of(cfg), tok[:, :-1], tok[:, 1:])
    return loss, torch.autograd.grad(loss, leaves)


def test_loss_gradients_match_the_reference():
    cfg = _smoke(capacity_factor=1.0)
    p = T.init_params(0, cfg, "cpu")
    tok = _tokens(cfg)
    loss, grads = _port_grads(cfg, p, tok)
    want_loss, want = _ref_grads(cfg, p, tok)
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()), rel=FWD_TOL)
    for g, w in zip(grads, want):
        assert float((g - w).abs().max()) <= GRAD_TOL * max(float(w.abs().max()), 1e-12)


def test_bf16_products_fail_the_tolerances():
    """The same weights in bf16 (the port's products then round their
    inputs to bf16) break at least one tolerance."""
    cfg = _smoke(capacity_factor=1.0)
    p = T.init_params(0, cfg, "cpu")
    tok = _tokens(cfg)
    # the matrices in bf16; norms and the router stay fp32, as the port keeps them
    bf = torch.utils._pytree.tree_map_with_path(
        lambda path, t: t if t.dim() < 2 or "router" in str(path) else t.to(torch.bfloat16), p)
    cfg_bf = dataclasses.replace(cfg, dtype="bfloat16")
    logits, _ = T.forward(bf, cfg_bf, tok[:, :-1])
    want, _ = R.forward(p, R.dims_of(cfg), tok[:, :-1])
    _, grads = _port_grads(cfg_bf, bf, tok)
    _, wgrads = _ref_grads(cfg, p, tok)
    fails = [_rel(logits.float(), want) > FWD_TOL]
    fails += [float((g.float() - w).abs().max()) > GRAD_TOL * float(w.abs().max())
              for g, w in zip(grads, wgrads)]
    assert any(fails)


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_expert_shares_add_up_to_the_whole_layer(dispatch):
    """Eight shares of 2 of 16 experts (expert parallelism over 8 cards):
    each share routes over all 16 and computes its own experts' part; the
    parts, with the shared experts counted once, equal the uncut
    reference layer, capacity drops included."""
    cfg = _smoke(n_experts=16, experts_held=0, expert_offset=0, capacity_factor=1.0,
                 dispatch=dispatch)
    whole = T.init_params(0, cfg, "cpu")
    mp = T.layer_params(whole["layers"], 0)["moe"]
    h = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(3))
    want, want_aux = R.moe(R.dims_of(cfg), mp, h)
    shared = R.moe(R.dims_of(cfg), mp, h, routed=False)[0]
    total = shared.clone()
    for j in range(8):
        share = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, experts_held=2,
                                                                 expert_offset=2 * j))
        sp = dict(mp, **{n: mp[n][2 * j:2 * j + 2] for n in ("up", "gate", "down")})
        y, aux = moe_lib.apply_moe(sp, h, share)
        total = total + (y - shared)
        assert float(moe_lib.moe_aux_loss(aux, share)) == pytest.approx(float(want_aux),
                                                                         rel=FWD_TOL)
    assert _rel(total, want) <= FWD_TOL


def _server(cfg, n_dev=8, seq=16, observe=None):
    stream = make_lm_stream(n_tokens=64 * (seq + 1), vocab=cfg.vocab_size, seed=0)
    cut = stream[:64 * (seq + 1)].reshape(64, seq + 1)
    x, y = cut[:, :-1], cut[:, 1:]
    data = FederatedData(SyntheticClassificationDataset(x[:48], y[:48], cfg.vocab_size),
                         SyntheticClassificationDataset(x[48:], y[48:], cfg.vocab_size),
                         [np.arange(i, 48, n_dev) for i in range(n_dev)])
    fl = FLConfig(n_devices=n_dev, k_select=2, rounds=1, l_ep=1, local_batch=3, lr=0.3,
                  seed=0, executor="vmapped", observe=observe)
    return FLServer(fl, LMTask(cfg, seq_len=seq), data, device="cpu")


def test_vmapped_fedrank_round_with_remat_equals_without(monkeypatch):
    """A FedRank round through ``FLServer.run_round`` and the vmapped
    executor: the same parameters with ``cfg.remat`` on and off; every leaf
    reaching the SGD update has contiguous client blocks."""
    seen = []
    real = fl_client.sgd_update

    def watched(a, g, lr):
        seen.append((_client_block_contiguous(a), _client_block_contiguous(g)))
        return real(a, g, lr)

    monkeypatch.setattr(fl_client, "sgd_update", watched)
    runs, init = {}, None
    for remat in (False, True):
        cfg = dataclasses.replace(_smoke(), remat=remat)
        srv = _server(cfg)
        init = srv.global_params if init is None else init
        srv.global_params = init
        res = srv.run_round(build_policy("fedrank", k=2, seed=0, device="cpu"))
        runs[remat] = (res, torch.utils._pytree.tree_leaves(srv.global_params))
    assert seen and all(a and g for a, g in seen)
    n_leaves = len(torch.utils._pytree.tree_leaves(init))
    assert len(seen) % n_leaves == 0
    np.testing.assert_array_equal(runs[False][0].selected, runs[True][0].selected)
    assert math.isfinite(runs[True][0].test_loss)
    for a, b in zip(runs[False][1], runs[True][1]):
        assert torch.equal(a, b)


def test_spans_and_counters_of_an_observed_round():
    """``mla`` and ``moe`` spans inside the gradient and the evaluation;
    the counters only from the evaluation's forwards (outside every
    transform): two forwards (accuracy, loss) x two expert layers."""
    cfg = _smoke(capacity_factor=1.0)
    rec = RunRecorder()
    srv = _server(cfg, observe=rec)
    try:
        srv.run_round(build_policy("fedavg"))
    finally:
        clear_profiler()
    spans = [s["span"] for s in rec.records[-1]["spans"]]
    leaves = [p.rsplit("/", 1)[-1] for p in spans]
    assert leaves.count("mla") > 0 and leaves.count("moe") > 0
    assert any(p.endswith("grad/mla") for p in spans) and any(p == "evaluate/moe" for p in spans)
    c = rec.records[-1]["metrics"]["counters"]
    moe = cfg.moe
    t = 16 * 16                                    # the test set, one batch
    cap = moe_lib._capacity(t, moe.n_experts, moe.top_k, moe.capacity_factor)
    assert c["moe.slots"] == 2 * 2 * moe.held * cap
    assert 0 < c["moe.pairs_kept"] <= c["moe.pairs_held"] <= 2 * 2 * t * moe.top_k


def test_serving_refuses_latent_attention():
    cfg = _smoke()
    p = T.init_params(0, cfg, "cpu")
    tok = _tokens(cfg)[:, :8]
    with pytest.raises(ValueError, match="latent KV cache"):
        T.prefill(p, cfg, tok)
    with pytest.raises(ValueError, match="latent KV cache"):
        T.init_decode_state(p, cfg, 2, 16)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite"])
def test_counter_masks_are_built_only_under_a_recorder(arch, monkeypatch):
    """Untraced, an expert layer's counters cost one check and build no
    mask; under a recorder, outside every transform, it builds them once."""
    built = []
    count = moe_lib._count
    monkeypatch.setattr(moe_lib, "_count", lambda masks, slots: count(
        lambda: built.append(1) or masks(), slots))
    cfg = get_model_config(arch, smoke=True)
    p = moe_lib.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(1))
    clear_profiler()
    moe_lib.apply_moe(p, x, cfg)
    assert built == []
    rec = RunRecorder()
    set_profiler(rec)
    try:
        torch.func.vmap(lambda xx: moe_lib.apply_moe(p, xx, cfg)[0])(x[None])
        assert built == []
        moe_lib.apply_moe(p, x, cfg)
    finally:
        clear_profiler()
    assert built == [1]
