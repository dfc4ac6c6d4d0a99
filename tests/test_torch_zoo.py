"""The rest of the model zoo in the port — the mixture-of-experts models
(olmoe-1b-7b, phi3.5-moe), whisper-medium's encoder-decoder and
internvl2-76b's frontend — against the JAX reference, on the CPU, at the
smoke configs in fp32.

The reference's weights are carried across with ``repro_torch.convert``;
tokens and frontend embeddings are made with numpy from a seed.
Tolerances:

* parameter layouts, decode-state layouts and steps: exactly equal;
* logits of ``forward``, ``prefill`` and decode steps: 1e-4, the tolerance
  ``tests/test_decode_consistency.py`` holds the reference's own prefill and
  decode to against its forward;
* whisper's cross-attention K/V: 1e-5 (fp32 sums of one layer);
* one ``make_train_step``: the loss, xent and aux within 1e-5, every
  gradient within 1e-5 of its leaf's largest magnitude (max 1); the update,
  fed the reference's gradients, within 1e-6 relative (as
  ``tests/test_torch_train.py``);
* serving: greedy tokens exactly equal (the batcher against each request
  run alone).

The first test is the positions fault's: a model that attends without RoPE
(whisper's decoder, stripped of its encoder as ``launch/train.py`` strips
it) adds the reference's sinusoidal positions in ``prefill`` and in every
decode step, not only in ``forward``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.configs import list_archs
from repro.models import transformer as JT
from repro.optim import adamw as jax_adamw
from repro_torch import optim as P
from repro_torch.configs import get_model_config
from repro_torch.convert import decode_state_from_numpy, params_from_numpy, params_to_numpy
from repro_torch.fl._tree import tree_leaves
from repro_torch.launch import steps as S
from repro_torch.launch.scheduler import ContinuousBatcher, Request
from repro_torch.launch.serve import serve
from repro_torch.models import transformer as T

ZOO = ["olmoe-1b-7b", "phi3.5-moe", "whisper-medium", "internvl2-76b"]
TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    return np.asarray(x, dtype=np.float32)


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=0, err_msg=str(what))


def _scaled_close(got, want, tol, what):
    want = _f32(want)
    err = float(np.abs(_f32(got) - want).max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), (what, err)


def _models(arch, seed=7, cfg_fn=None):
    cfg, tcfg = jax_config(arch, smoke=True), get_model_config(arch, smoke=True)
    if cfg_fn is not None:
        cfg, tcfg = cfg_fn(cfg), cfg_fn(tcfg)
    jp = JT.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, tcfg, jp, params_from_numpy(_np(jp), "cpu")


def _frontend(cfg, b, seed=0):
    """Random frontend embeddings (B, n, embed_dim), or None."""
    if cfg.frontend is None:
        return None
    n = cfg.enc_seq if cfg.enc_dec else cfg.frontend.n_tokens
    return np.random.default_rng(seed).normal(size=(b, n, cfg.frontend.embed_dim)
                                              ).astype(np.float32)


def _jit(cfg):
    """The reference's forward, prefill and decode step, jitted for ``cfg``
    (eager calls would trace their layer scans on every call)."""
    return (jax.jit(lambda p, t, fe: JT.forward(p, cfg, t, fe)),
            jax.jit(lambda p, t, fe, n: JT.prefill(p, cfg, t, fe, max_len=n),
                    static_argnums=3),
            jax.jit(lambda p, st, t: JT.decode_step(p, cfg, st, t)))


def _both(a):
    return (None, None) if a is None else (jnp.asarray(a), torch.as_tensor(a))


def _strip(cfg):
    """``launch/train.py``'s frontend strip: whisper trains as a decoder."""
    return dataclasses.replace(cfg, frontend=None, enc_dec=False, n_enc_layers=0, enc_seq=0)


# ---------------------------------------------------------------------------
# the positions fault
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["naive", "flash"])
def test_stripped_whisper_prefill_and_decode_add_positions(impl):
    cfg, tcfg, jp, tp = _models("whisper-medium", cfg_fn=_strip)
    assert not tcfg.use_rope and tcfg.attention == "full" and not tcfg.enc_dec
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    j_forward, j_prefill, j_decode = _jit(cfg)
    want, _ = j_forward(jp, jnp.asarray(tok), None)
    jlog, jst = j_prefill(jp, jnp.asarray(tok[:, :12]), None, 20)
    tlog, tst = T.prefill(tp, tcfg, torch.as_tensor(tok[:, :12]), max_len=20, impl=impl)
    _close(tlog, jlog, what="prefill")
    _close(tlog, want[:, :12], what="prefill vs forward")
    for t in range(12, 20):
        jl, jst = j_decode(jp, jst, jnp.asarray(tok[:, t]))
        tl, tst = T.decode_step(tp, tcfg, tst, torch.as_tensor(tok[:, t]))
        _close(tl, jl, what=("decode", t))
        _close(tl, want[:, t], what=("decode vs forward", t))
    # the in-place step of the serving loops adds the same positions
    _, st = T.prefill(tp, tcfg, torch.as_tensor(tok[:, :12]), max_len=20, impl=impl)
    tl, _ = T._decode_step_into(tp, tcfg, st, torch.as_tensor(tok[:, 12]))
    _close(tl, want[:, 12], what="decode_step_into")


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _layout(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@pytest.mark.parametrize("arch", list_archs())
def test_init_params_layout_matches_the_reference(arch):
    cfg = jax_config(arch, smoke=True)
    want = _layout(jax.eval_shape(lambda k: JT.init_params(k, cfg), jax.random.PRNGKey(0)))
    got = T.init_params(0, get_model_config(arch, smoke=True), "cpu")
    assert _layout(got) == want
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(got))


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-76b"])
def test_frontend_proj_matches_the_reference(arch):
    """A frontend narrower than d_model (no shipped config has one) adds
    ``frontend_proj`` (embed_dim, d_model); forward and the loss go through
    it as the reference's do."""
    def narrow(c):
        return dataclasses.replace(c, frontend=dataclasses.replace(c.frontend, embed_dim=48))

    cfg, tcfg, jp, tp = _models(arch, seed=2, cfg_fn=narrow)
    assert tuple(tp["frontend_proj"].shape) == (48, tcfg.d_model)
    assert _layout(T.init_params(0, tcfg, "cpu")) == _layout(_np(jp))
    rng = np.random.default_rng(2)
    tok = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jfe, tfe = _both(_frontend(cfg, 2, seed=2))
    want, _ = _jit(cfg)[0](jp, jnp.asarray(tok), jfe)
    got, _ = T.forward(tp, tcfg, torch.as_tensor(tok), tfe)
    _close(got, want)
    batch = {"tokens": tok, "labels": rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)}
    jl, _ = JT.loss_fn(jp, cfg, dict({k: jnp.asarray(v) for k, v in batch.items()},
                                     frontend_embeds=jfe))
    tl, _ = T.loss_fn(tp, tcfg, dict({k: torch.as_tensor(v) for k, v in batch.items()},
                                     frontend_embeds=tfe))
    assert abs(float(tl) - float(jl)) < 1e-5


# ---------------------------------------------------------------------------
# whisper's encoder-decoder
# ---------------------------------------------------------------------------


def test_whisper_init_decode_state_matches_the_reference():
    """The encoder runs in ``init_decode_state``: the stacked cross K/V as
    the reference's, zeroed self-attention caches, and decoding from that
    state token by token gives the reference's logits."""
    cfg, tcfg, jp, tp = _models("whisper-medium", seed=4)
    jfe, tfe = _both(_frontend(cfg, 2, seed=4))
    jst = JT.init_decode_state(jp, cfg, 2, 16, frontend_embeds=jfe)
    for impl in ("naive", "flash"):
        tst = T.init_decode_state(tp, tcfg, 2, 16, frontend_embeds=tfe, impl=impl)
        assert len(tst.cross_kv) == 2
        for got, want in zip(tst.cross_kv, jst.cross_kv):
            assert tuple(got.shape) == want.shape == (cfg.n_layers, 2, cfg.enc_seq,
                                                      cfg.n_kv_heads, cfg.head_dim)
            _close(got, want, 1e-5)
        assert tuple(tst.layers["kv"].k.shape) == jst.layers["kv"].k.shape
        assert not tst.layers["kv"].k.any() and not tst.step.any()
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    j_decode = _jit(cfg)[2]
    for t in range(6):
        jl, jst = j_decode(jp, jst, jnp.asarray(tok[:, t]))
        tl, tst = T.decode_step(tp, tcfg, tst, torch.as_tensor(tok[:, t]))
        _close(tl, jl, what=t)
    with pytest.raises(ValueError, match="frontend_embeds"):
        T.init_decode_state(tp, tcfg, 2, 16)


def test_whisper_cross_kv_converts_and_decodes():
    """The reference's primed state (ring caches and stacked cross K/V),
    carried across with ``decode_state_from_numpy``, decodes as the
    reference's; the port's own prefill leaves the same cross K/V."""
    cfg, tcfg, jp, tp = _models("whisper-medium", seed=5)
    jfe, tfe = _both(_frontend(cfg, 2, seed=5))
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 14)).astype(np.int32)
    _, j_prefill, j_decode = _jit(cfg)
    _, jst = j_prefill(jp, jnp.asarray(tok[:, :8]), jfe, 14)
    st = decode_state_from_numpy(_np(jst), "cpu")
    assert isinstance(st.cross_kv, tuple) and len(st.cross_kv) == 2
    _, own = T.prefill(tp, tcfg, torch.as_tensor(tok[:, :8]), tfe, max_len=14, impl="flash")
    for a, b in zip(own.cross_kv, st.cross_kv):
        _close(a, b, 1e-5)
    for t in range(8, 14):
        jl, jst = j_decode(jp, jst, jnp.asarray(tok[:, t]))
        tl, st = T.decode_step(tp, tcfg, st, torch.as_tensor(tok[:, t]))
        _close(tl, jl, what=t)
    np.testing.assert_array_equal(st.step.numpy(), np.full(2, 14))


def test_decode_step_shares_the_cross_kv_and_leaves_the_state():
    cfg, tcfg, _, tp = _models("whisper-medium", seed=6)
    _, tfe = _both(_frontend(cfg, 2, seed=6))
    tok = torch.as_tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 9)))
    _, st = T.prefill(tp, tcfg, tok[:, :8], tfe, max_len=12)
    def caches():
        return [t for c in st.layers.values() for t in c]

    before = [t.clone() for t in caches()]
    a, new = T.decode_step(tp, tcfg, st, tok[:, 8])
    b, _ = T.decode_step(tp, tcfg, st, tok[:, 8])
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(before, caches()))
    assert new.cross_kv[0] is st.cross_kv[0] and new.cross_kv[1] is st.cross_kv[1]


# ---------------------------------------------------------------------------
# internvl2's frontend
# ---------------------------------------------------------------------------


def test_vlm_loss_covers_the_text_positions_only():
    cfg, tcfg, jp, tp = _models("internvl2-76b", seed=8)
    rng = np.random.default_rng(8)
    tok = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    lab = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.3).astype(np.float32)
    jfe, tfe = _both(_frontend(cfg, 2, seed=8))
    jb = {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
          "loss_mask": jnp.asarray(mask), "frontend_embeds": jfe}
    tb = {"tokens": torch.as_tensor(tok), "labels": torch.as_tensor(lab),
          "loss_mask": torch.as_tensor(mask), "frontend_embeds": tfe}
    jl, jm = JT.loss_fn(jp, cfg, jb)
    tl, tm = T.loss_fn(tp, tcfg, tb)
    assert abs(float(tl) - float(jl)) < 1e-5 and abs(float(tm["xent"]) - float(jm["xent"])) < 1e-5
    logits, _ = T.forward(tp, tcfg, tb["tokens"], tfe)
    assert logits.shape == (2, tcfg.frontend.n_tokens + 12, tcfg.vocab_size)
    from repro_torch.models.layers import softmax_xent

    text = softmax_xent(logits[:, tcfg.frontend.n_tokens:], tb["labels"], tb["loss_mask"])
    assert float(tl) == float(text)
    with pytest.raises(ValueError, match="frontend_embeds"):
        T.forward(tp, tcfg, tb["tokens"])


# ---------------------------------------------------------------------------
# training: one make_train_step per family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_train_step_equals_the_reference(arch):
    """The whole model: whisper with its encoder over frames and the VLM
    over image tokens (``frontend_embeds`` in the batch), the MoE models'
    router losses in the loss; the ``blocked`` route, so whisper's encoder
    takes the reference's bidirectional chunked attention."""
    cfg, tcfg, jp, tp = _models(arch, seed=9)
    rng = np.random.default_rng(9)
    b, s = 2, 16
    jbatch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    fe = _frontend(cfg, b, seed=9)
    if fe is not None:
        jbatch["frontend_embeds"] = fe
    jopt = jax_adamw(1e-3, weight_decay=0.1, grad_clip=1.0)
    js = jopt.init(jp)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, bt: JT.loss_fn(p, cfg, bt, impl="blocked"), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in jbatch.items()})
    want_p, _ = jopt.update(jgrads, jp, js)
    if cfg.moe is not None:
        assert float(jm["aux"]) > 0
    ref_grads = params_from_numpy(_np(jgrads), "cpu")
    topt = P.adamw(1e-3, weight_decay=0.1, grad_clip=1.0)
    seen = []

    def update(grads, params, state):         # record the port's gradients,
        seen.append(grads)                     # step with the reference's
        return topt.update(ref_grads, params, state)

    step = S.make_train_step(tcfg, P.Optimizer(topt.init, update))
    new_p, _, metrics = step(tp, topt.init(tp),
                             {k: torch.as_tensor(v) for k, v in jbatch.items()})
    for key, want in (("loss", jloss), ("xent", jm["xent"]), ("aux", jm["aux"])):
        assert abs(float(metrics[key]) - float(want)) <= 1e-5, (key, float(metrics[key]))
    got_leaves = tree_leaves(params_to_numpy(seen[0]))
    want_leaves = jax.tree.leaves(_np(jgrads))
    assert len(got_leaves) == len(want_leaves)
    for i, (got, want) in enumerate(zip(got_leaves, want_leaves)):
        _scaled_close(got, want, 1e-5, ("grad", i))
    for got, want in zip(tree_leaves(params_to_numpy(new_p)), jax.tree.leaves(_np(want_p))):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def test_remat_keeps_the_moe_aux():
    """A checkpointed layer returns its router losses too: remat on and off
    give the same loss, aux and gradients."""
    tcfg = get_model_config("olmoe-1b-7b", smoke=True)
    params = T.init_params(0, tcfg, "cpu")
    tok = torch.as_tensor(np.random.default_rng(1).integers(0, tcfg.vocab_size, (2, 16)))
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        live = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
        from repro_torch.fl._tree import tree_unflatten

        loss, m = T.loss_fn(tree_unflatten(params, live), cfg, batch)
        out[remat] = (float(loss), float(m["aux"]), torch.autograd.grad(loss, live))
    assert out[True][:2] == out[False][:2] and out[True][1] > 0
    assert all(torch.equal(a, b) for a, b in zip(out[True][2], out[False][2]))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_runs_the_moe_model_on_the_cpu():
    for layers in (None, 1):
        stats = serve("olmoe-1b-7b", smoke=True, batch=2, prompt_len=8, gen=4,
                      temperature=0.0, verbose=False, device="cpu", layers=layers)
        assert all(np.isfinite(v) and v > 0 for v in stats.values())


def _greedy_alone(tcfg, tp, prompt, max_new, frames=None):
    """One request decoded token by token from an empty state."""
    st = T.init_decode_state(tp, tcfg, 1, 64, frontend_embeds=frames)
    out, tok = [], None
    for t in range(len(prompt) + max_new - 1):
        cur = prompt[t] if t < len(prompt) else tok
        lg, st = T.decode_step(tp, tcfg, st, torch.as_tensor([cur]))
        tok = int(lg.argmax(-1)[0])
        if t >= len(prompt) - 1:
            out.append(tok)
    return out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-medium"])
def test_continuous_batcher_equals_requests_alone(arch):
    """Five requests through two slots (greedy): each request's tokens as
    that request decoded alone; whisper's slots keep their audio (the cross
    K/V) across the slot resets."""
    _, tcfg, _, tp = _models(arch, seed=10)
    frames = None
    if tcfg.enc_dec:
        frames = torch.as_tensor(_frontend(tcfg, 2, seed=10))
    batcher = ContinuousBatcher(tcfg, tp, batch_slots=2, max_len=64, device="cpu",
                                frontend_embeds=frames)
    cross = None if frames is None else [t.clone() for t in batcher.state.cross_kv]
    rng = np.random.default_rng(10)
    reqs = [Request(rid=i, prompt=rng.integers(0, tcfg.vocab_size, int(n)).astype(np.int32),
                    max_new=3) for i, n in enumerate(rng.integers(2, 7, 5))]
    slot_of = {}
    for r in reqs:
        batcher.submit(r)
    while batcher.queue or any(batcher.slot_req):
        batcher._admit()
        for slot, r in enumerate(batcher.slot_req):
            if r is not None:
                slot_of.setdefault(r.rid, slot)
        batcher.step()
    assert len(batcher.completed) == 5
    for r in batcher.completed:
        fr = None if frames is None else frames[slot_of[r.rid]:slot_of[r.rid] + 1]
        assert r.out == _greedy_alone(tcfg, tp, r.prompt, 3, fr), r.rid
    if cross is not None:
        assert all(torch.equal(a, b) for a, b in zip(cross, batcher.state.cross_kv))
