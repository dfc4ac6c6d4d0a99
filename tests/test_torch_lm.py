"""The LM of the port (configs, layers, attention, transformer) against the
JAX reference, on the CPU.

Inputs are made with numpy from a seed and given to both; the reference's
weights are carried across with ``repro_torch.convert``.  Tolerances:

* configs, the token stream: exactly equal;
* norms, RoPE, activations, MLPs, sinusoids: 1e-6 (the same fp32
  arithmetic, other kernels);
* attention (``naive``, ``flash``, ``blocked``, decode): 1e-5 (fp32 sums in
  another order);
* whole models (``forward``, ``prefill``, ``decode_step``, the loss): 1e-4
  on the logits, the tolerance ``tests/test_decode_consistency.py`` uses
  for the reference's own prefill + decode against its forward; the
  recurrent states a prefill leaves (RWKV6's, Hymba's Mamba heads') within
  1e-4 * max(1, max |ref|).

The SSM and hybrid families (rwkv6-3b, hymba-1.5b) run both prefill routes:
``impl="naive"`` (the reference's default math) and ``impl="flash"`` (the
kernels' route, whose ops take their plain versions on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import get_model_config as jax_config
from repro.configs import list_archs as jax_archs
from repro.data import make_lm_stream as jax_lm_stream
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import INPUT_SHAPES, get_model_config, get_shape, list_archs
from repro_torch.convert import (
    decode_state_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from repro_torch.data import make_lm_stream
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

ATTN_ARCHS = ["yi-6b", "h2o-danube-3-4b", "minitron-4b", "gemma-7b"]
SSM_ARCHS = ["rwkv6-3b", "hymba-1.5b"]
# the MoE models, whisper's encoder-decoder and the VLM (frontend embeddings)
ZOO_ARCHS = ["olmoe-1b-7b", "phi3.5-moe", "whisper-medium", "internvl2-76b"]


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(x):
    return torch.as_tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------


def test_every_architecture_and_shape_equals_the_reference():
    assert list_archs() == jax_archs()
    for arch in list_archs():
        for smoke in (False, True):
            want = dataclasses.asdict(jax_config(arch, smoke=smoke))
            got = dataclasses.asdict(get_model_config(arch, smoke=smoke))
            assert got == want, (arch, smoke)
            cfg, jcfg = get_model_config(arch, smoke=smoke), jax_config(arch, smoke=smoke)
            assert (cfg.param_count(), cfg.active_param_count(), cfg.group_size,
                    cfg.supports_long_context()) == (
                jcfg.param_count(), jcfg.active_param_count(), jcfg.group_size,
                jcfg.supports_long_context())
    assert get_model_config("phi3.5-moe").name == jax_config("phi3.5-moe").name
    assert [dataclasses.asdict(s) for s in INPUT_SHAPES] == [
        dataclasses.asdict(s) for s in jax_base.INPUT_SHAPES]
    assert get_shape("decode_32k").seq_len == 32_768
    with pytest.raises(KeyError, match="unknown architecture"):
        get_model_config("no-such-arch")
    assert get_model_config("yi-6b").param_count() == 6_061_031_424


@pytest.mark.parametrize("vocab,seed", [(256, 0), (64_000, 3)])
def test_lm_stream_is_bit_identical(vocab, seed):
    np.testing.assert_array_equal(make_lm_stream(3000, vocab=vocab, seed=seed),
                                  jax_lm_stream(3000, vocab=vocab, seed=seed))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match(kind):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 48)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.normal(size=48).astype(np.float32),
         "bias": rng.normal(size=48).astype(np.float32)}
    want = JL.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    got = L.apply_norm(kind, {k: _t(v) for k, v in p.items()}, _t(x))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=1e-6)
    init = L.init_norm(kind, 48, torch.float32, torch.device("cpu"), (3,))
    assert init["scale"].shape == (3, 48) and bool((init["scale"] == 1).all())


def test_rope_and_sinusoids_match():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 7)).astype(np.int32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(L.apply_rope(_t(x), _t(pos), 10000.0).numpy(), _np(want),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(L.rope_freqs(120, 5e5).numpy(), _np(JL.rope_freqs(120, 5e5)),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(L.sinusoidal_positions(50, 64).numpy(),
                               _np(JL.sinusoidal_positions(50, 64)), atol=1e-6, rtol=0)
    np.testing.assert_allclose(L.sinusoidal_at(torch.tensor(37), 64).numpy(),
                               _np(JL.sinusoidal_at(jnp.asarray(37), 64)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu", "relu2"])
def test_mlp_activations_match(act):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 16)).astype(np.float32)
    p = {k: (rng.normal(size=shape) * 0.3).astype(np.float32)
         for k, shape in (("up", (16, 40)), ("down", (40, 16)), ("gate", (16, 40)))}
    if not JL.is_gated(act):
        del p["gate"]
    assert L.is_gated(act) == JL.is_gated(act)
    want = JL.apply_mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), act)
    got = L.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), act)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(L.activation_fn(act)(_t(x)).numpy(),
                               _np(JL.activation_fn(act)(jnp.asarray(x))), atol=1e-6, rtol=0)


def test_initializers_draw_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    w = L.dense_init_on(gen, 256, 512, torch.bfloat16, lead=(2,))
    assert w.shape == (2, 256, 512) and w.dtype == torch.bfloat16
    wf = w.float() * 16.0                         # N(0, 1) cut at +-2
    assert float(wf.abs().max()) <= 2.0 + 1e-2 and abs(float(wf.std()) - 0.88) < 0.02
    e = L.embed_init(gen, 1000, 64, torch.float32)
    assert abs(float(e.std()) - 0.02) < 1e-3
    mlp = L.init_mlp(gen, 32, 64, "relu2", torch.float32)
    assert sorted(mlp) == ["down", "up"]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_params(cfg, seed):
    p = JA.init_attention(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return p, params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


@pytest.mark.parametrize("arch", ["yi-6b", "h2o-danube-3-4b"])
def test_attention_prefill_routes_match(arch):
    cfg = jax_config(arch, smoke=True)
    jp, tp = _attn_params(cfg, 0)
    x = np.random.default_rng(0).normal(size=(2, 80, cfg.d_model)).astype(np.float32)
    window = cfg.window if cfg.attention == "swa" else None
    want, (jk, _) = JA.attention_prefill(jp, jnp.asarray(x), cfg, window=window)
    tcfg = get_model_config(arch, smoke=True)
    for impl in ("naive", "flash", "blocked"):
        got, (tk, _) = A.attention_prefill(tp, _t(x), tcfg, window=window, impl=impl)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tk.numpy(), _np(jk), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        A.attention_prefill(tp, _t(x), tcfg, impl="pallas")


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 40)])
def test_blocked_and_naive_attention_match(causal, window):
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(1, 96, n, 16)).astype(np.float32) for n in (4, 2, 2))
    want = JA.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, window=window, q_chunk=32, kv_chunk=32)
    got = A.blocked_attention(_t(q), _t(k), _t(v), causal=causal, window=window,
                              q_chunk=32, kv_chunk=32)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
    kv_valid = rng.random((1, 96)) > 0.2
    kv_valid[:, 0] = True
    want = JA.naive_attention(jnp.asarray(q[:, :3]), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, q_offset=50,
                              kv_valid=jnp.asarray(kv_valid))
    got = A.naive_attention(_t(q[:, :3]), _t(k), _t(v), causal=causal, window=window,
                            q_offset=50, kv_valid=_t(kv_valid))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)


def test_attention_decode_ring_cache_matches():
    """Per-sequence lengths, one sequence past the ring's capacity."""
    cfg = jax_config("h2o-danube-3-4b", smoke=True)
    tcfg = get_model_config("h2o-danube-3-4b", smoke=True)
    jp, tp = _attn_params(cfg, 1)
    rng = np.random.default_rng(5)
    cap = 16
    shape = (2, cap, cfg.n_kv_heads, cfg.head_dim)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    length = np.array([5, 37], np.int32)
    jcache = JA.KVCache(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(length))
    tcache = A.KVCache(_t(k0.copy()), _t(v0.copy()), _t(length))
    for step in range(3):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = JA.attention_decode(jp, jnp.asarray(x), jcache, cfg, window=12)
        got, tcache = A.attention_decode(tp, _t(x), tcache, tcfg, window=12)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=0)
        np.testing.assert_allclose(tcache.k.numpy(), _np(jcache.k), atol=1e-5, rtol=0)
        np.testing.assert_array_equal(tcache.length.numpy(), np.asarray(jcache.length))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _jit(cfg):
    """The reference's forward, prefill and decode step, jitted for ``cfg``
    (eager calls would trace and compile their layer scans on every call)."""
    return (jax.jit(lambda p, t, fe=None: JT.forward(p, cfg, t, fe)),
            jax.jit(lambda p, t, n, fe=None: JT.prefill(p, cfg, t, fe, max_len=n),
                    static_argnums=2),
            jax.jit(lambda p, st, t: JT.decode_step(p, cfg, st, t)))


def _frontend_embeds(cfg, b, seed=0):
    """Random frontend embeddings (B, n, embed_dim) for whisper's encoder
    (n frames) and the VLM (n image tokens), else None."""
    if cfg.frontend is None:
        return None
    n = cfg.enc_seq if cfg.enc_dec else cfg.frontend.n_tokens
    return np.random.default_rng(seed).normal(size=(b, n, cfg.frontend.embed_dim)
                                              ).astype(np.float32)


def _models(arch, seed=7, **overrides):
    cfg = dataclasses.replace(jax_config(arch, smoke=True), **overrides)
    tcfg = dataclasses.replace(get_model_config(arch, smoke=True), **overrides)
    jp = JT.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch", ATTN_ARCHS + SSM_ARCHS + ZOO_ARCHS)
def test_forward_prefill_decode_match_the_reference(arch):
    """The MoE models' aux (their router losses) as the reference's too;
    whisper and the VLM take frontend embeddings, and the VLM's image
    tokens come first in the logits and in the cache."""
    cfg, tcfg, jp, tp = _models(arch)
    # past the smoke window (64) for the sliding-window models; RWKV6's
    # prefill of 128 tokens takes its chunked form (64-token chunks)
    s = 80 if cfg.window else 20
    half = s - 6
    if arch == "rwkv6-3b":
        s, half = 136, 128
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
    fe = _frontend_embeds(cfg, 2)
    jfe, tfe = (None, None) if fe is None else (jnp.asarray(fe), _t(fe))
    off = cfg.frontend.n_tokens if cfg.frontend is not None and not cfg.enc_dec else 0
    j_forward, j_prefill, j_decode = _jit(cfg)
    want, jaux = j_forward(jp, jnp.asarray(tok), jfe)
    got, aux = T.forward(tp, tcfg, _t(tok), tfe)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=0)
    if cfg.moe is None:
        assert float(aux) == 0.0
    else:
        assert float(aux) > 0 and abs(float(aux) - float(jaux)) <= 1e-6
    jlog, jst = j_prefill(jp, jnp.asarray(tok[:, :half]), s + off, jfe)
    jsteps = []
    for t in range(half, s):
        lg, jst = j_decode(jp, jst, jnp.asarray(tok[:, t]))
        jsteps.append(_np(lg))
    for impl in ("naive", "flash"):
        tlog, tst = T.prefill(tp, tcfg, _t(tok[:, :half]), tfe, max_len=s + off, impl=impl)
        np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=1e-4, rtol=0)
        for t, ref in zip(range(half, s), jsteps):
            lg, tst = T.decode_step(tp, tcfg, tst, _t(tok[:, t]))
            np.testing.assert_allclose(lg.numpy(), ref, atol=1e-4, rtol=0)
            np.testing.assert_allclose(lg.numpy(), _np(want[:, off + t]), atol=1e-4, rtol=0)
        np.testing.assert_array_equal(tst.step.numpy(), np.full(2, off + s))


def test_prefill_last_only_and_state_conversion():
    cfg, tcfg, jp, tp = _models("yi-6b")
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    jlog, jst = JT.prefill(jp, cfg, jnp.asarray(tok[:, :10]), max_len=16, last_only=True)
    tlog, tst = T.prefill(tp, tcfg, _t(tok[:, :10]), max_len=16, impl="flash",
                          last_only=True)
    assert tlog.shape == (2, 1, cfg.vocab_size)
    np.testing.assert_allclose(tlog.numpy(), _np(jlog), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tst.layers["kv"].k.numpy(), _np(jst.layers["kv"].k),
                               atol=1e-5, rtol=0)
    # the reference's primed state, carried across, decodes as the port's own
    st = decode_state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    jl, _ = JT.decode_step(jp, cfg, jst, jnp.asarray(tok[:, 10]))
    tl, _ = T.decode_step(tp, tcfg, st, _t(tok[:, 10]))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=0)
    back = params_to_numpy(tp)
    np.testing.assert_array_equal(back["layers"]["attn"]["wq"],
                                  np.asarray(jp["layers"]["attn"]["wq"]))


def test_ring_prefill_wraps_past_the_window():
    """A prompt longer than the ring (s > cap) packs the last cap keys."""
    cfg, tcfg, jp, tp = _models("h2o-danube-3-4b", seed=3)
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (1, 150)).astype(np.int32)
    _, jst = JT.prefill(jp, cfg, jnp.asarray(tok[:, :140]), max_len=150)
    _, tst = T.prefill(tp, tcfg, _t(tok[:, :140]), max_len=150, impl="flash")
    assert tst.layers["kv"].k.shape[2] == cfg.window
    np.testing.assert_allclose(tst.layers["kv"].k.numpy(), _np(jst.layers["kv"].k),
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tst.layers["kv"].length.numpy(),
                                  np.asarray(jst.layers["kv"].length))


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float8_e4m3fn"])
def test_quantized_kv_cache_matches(kv_dtype):
    cfg, tcfg, jp, tp = _models("yi-6b", seed=11, kv_cache_dtype=kv_dtype)
    assert T.kv_cache_dtype(tcfg) == getattr(torch, kv_dtype)
    tok = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    j_forward, j_prefill, j_decode = _jit(cfg)
    full, _ = j_forward(jp, jnp.asarray(tok))
    _, jst = j_prefill(jp, jnp.asarray(tok[:, :8]), 16)
    _, tst = T.prefill(tp, tcfg, _t(tok[:, :8]), max_len=16, impl="flash")
    assert tst.layers["kv"].k.dtype == getattr(torch, kv_dtype)
    for t in range(8, 16):
        jl, jst = j_decode(jp, jst, jnp.asarray(tok[:, t]))
        tl, tst = T.decode_step(tp, tcfg, tst, _t(tok[:, t]))
        # the same rounding of the same K/V on both sides
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=0)
        if kv_dtype == "bfloat16":   # the reference's own bound against its forward
            assert float(np.abs(tl.numpy() - _np(full[:, t])).max()) < 0.15


def test_loss_matches():
    cfg, tcfg, jp, tp = _models("gemma-7b", seed=5)
    rng = np.random.default_rng(5)
    tok = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    mask = (rng.random((2, 10)) > 0.3).astype(np.float32)
    batch = {"tokens": tok, "labels": lab, "loss_mask": mask}
    want, wm = JT.loss_fn(jp, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got, gm = T.loss_fn(tp, tcfg, {k: _t(v) for k, v in batch.items()})
    assert abs(float(got) - float(want)) < 1e-5
    assert abs(float(gm["xent"]) - float(wm["xent"])) < 1e-5


def test_init_params_layout_matches_the_reference():
    for arch in ATTN_ARCHS + SSM_ARCHS + ZOO_ARCHS:
        cfg = jax_config(arch, smoke=True)
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                            JT.init_params(jax.random.PRNGKey(0), cfg))
        got = T.init_params(0, get_model_config(arch, smoke=True), "cpu")
        got = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")),
                           got)
        assert got == want, arch


def _close_scaled(got, want, tol=1e-4):
    want = _np(want)
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=tol * max(1.0, float(np.abs(want).max())), rtol=0)


@pytest.mark.parametrize("arch,prompt", [("rwkv6-3b", 128), ("hymba-1.5b", 70)])
def test_ssm_prefill_states_and_state_conversion(arch, prompt):
    """The recurrent states a prefill leaves equal the reference's, on both
    routes; the reference's primed state, carried across, decodes as the
    port's own; ``forward(impl="flash")`` equals the reference's forward."""
    cfg, tcfg, jp, tp = _models(arch, seed=9)
    n = prompt + 4
    tok = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, n)).astype(np.int32)
    j_forward, j_prefill, j_decode = _jit(cfg)
    want, _ = j_forward(jp, jnp.asarray(tok))
    got, _ = T.forward(tp, tcfg, _t(tok), impl="flash")
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=0)
    _, jst = j_prefill(jp, jnp.asarray(tok[:, :prompt]), n)
    names = sorted(jst.layers)
    assert names == (["rwkv"] if arch == "rwkv6-3b" else ["kv", "mamba"])
    for impl in ("naive", "flash"):
        _, tst = T.prefill(tp, tcfg, _t(tok[:, :prompt]), max_len=n, impl=impl)
        assert sorted(tst.layers) == names
        for name in names:
            for g, w in zip(tst.layers[name], jst.layers[name]):
                assert tuple(g.shape) == w.shape
                _close_scaled(g, w)
    st = decode_state_from_numpy(jax.tree.map(np.asarray, jst), "cpu")
    assert sorted(st.layers) == names
    for t in range(prompt, n):
        jl, jst = j_decode(jp, jst, jnp.asarray(tok[:, t]))
        tl, st = T.decode_step(tp, tcfg, st, _t(tok[:, t]))
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-4, rtol=0)
        np.testing.assert_allclose(tl.numpy(), _np(want[:, t]), atol=1e-4, rtol=0)
    for name in names:
        for g, w in zip(st.layers[name], jst.layers[name]):
            _close_scaled(g, w)


def test_bf16_ssm_models_prefill_and_decode():
    """bf16 weights (the serving dtype): every route runs, keeps the cache
    dtypes, and the kernels' route agrees with the reference's default math
    within 4 bf16 ulps of the logits' scale (the two routes' fp32 results
    round to bf16 at the layer outputs, and a flipped rounding carries
    through the next layer)."""
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_model_config(arch, smoke=True), dtype="bfloat16")
        p = T.init_params(3, cfg, "cpu")
        tok = torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, 64)))
        lg = {}
        for impl in ("naive", "flash"):
            lg[impl], st = T.prefill(p, cfg, tok, max_len=70, impl=impl, last_only=True)
            for name, c in st.layers.items():
                assert c[0].shape[:2] == (cfg.n_layers, 2), name
            step, _ = T.decode_step(p, cfg, st, tok[:, -1])
            assert bool(torch.isfinite(step.float()).all())
        if arch == "rwkv6-3b":
            assert st.layers["rwkv"].wkv.dtype == torch.float32
            assert st.layers["rwkv"].shift_tm.dtype == torch.bfloat16
        else:
            assert st.layers["mamba"].conv.dtype == torch.bfloat16
        scale = float(lg["naive"].float().abs().max())
        assert float((lg["naive"].float() - lg["flash"].float()).abs().max()) \
            <= 2.0 ** -6 * scale
