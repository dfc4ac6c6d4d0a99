"""The port's serving path (``launch/``) against the JAX reference, on the CPU.

* ``serve`` runs end to end on reduced configs (greedy, ``device="cpu"``)
  and returns the reference's stats.
* The step functions: prefill by the kernel route (the port's default) and
  teacher-forced decode steps give the reference's logits from the same
  weights (1e-4, as ``tests/test_decode_consistency.py``).
* ``ContinuousBatcher`` (the attention, SSM and hybrid families): every
  request gets the greedy tokens the same request gets decoded alone
  (exactly), so no slot inherits the recurrent state of the request before
  it, and the reference's batcher's tokens
  wherever the reference's top-2 logit gap exceeds 1e-4 — past the first
  step whose gap is that close, fp32 sums in another order may pick the
  other token, and the rest of the request may differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.launch.scheduler import ContinuousBatcher as JaxBatcher
from repro.launch.scheduler import Request as JaxRequest
from repro.models import transformer as JT
from repro_torch.configs import get_model_config, get_shape
from repro_torch.convert import params_from_numpy
from repro_torch.launch.scheduler import ContinuousBatcher, Request, ServeStats
from repro_torch.launch.serve import serve
from repro_torch.launch.steps import make_prefill_step, make_serve_step, text_len
from repro_torch.models import transformer as T

GAP = 1e-4


def _models(arch, seed=0):
    cfg = jax_config(arch, smoke=True)
    jp = JT.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, get_model_config(arch, smoke=True), jp, params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu")


LM_ARCHS = ["yi-6b", "h2o-danube-3-4b", "rwkv6-3b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_serve_runs_greedy_on_the_cpu(arch, capsys):
    stats = serve(arch, smoke=True, batch=2, prompt_len=70, gen=5, temperature=0.0,
                  device="cpu")
    assert set(stats) == {"prefill_s", "decode_s", "decode_tok_per_s",
                          "prefill_tok_per_s"}
    assert all(np.isfinite(v) and v > 0 for v in stats.values())
    assert "sample:" in capsys.readouterr().out


def test_serve_samples_with_temperature():
    stats = serve("minitron-4b", smoke=True, batch=2, prompt_len=8, gen=4,
                  temperature=0.8, verbose=False, device="cpu")
    assert stats["decode_tok_per_s"] > 0


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_and_teacher_forced_decode_match_the_reference(arch):
    cfg, tcfg, jp, tp = _models(arch, seed=2)
    shape = dataclasses.replace(get_shape("decode_32k"), seq_len=96)
    assert text_len(tcfg, shape) == 96
    tok = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 90)).astype(np.int32)
    jlog, jst = JT.prefill(jp, cfg, jnp.asarray(tok[:, :84]), max_len=96, last_only=True)
    logits, st = make_prefill_step(tcfg, shape)(tp, {"tokens": torch.as_tensor(tok[:, :84])})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlog[:, 0]), atol=1e-4, rtol=0)
    j_step = jax.jit(lambda p, s, t: JT.decode_step(p, cfg, s, t))
    step = make_serve_step(tcfg)
    for t in range(84, 90):
        jl, jst = j_step(jp, jst, jnp.asarray(tok[:, t]))
        tl, st = step(tp, st, torch.as_tensor(tok[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def _greedy_alone(cfg, params, prompt, max_new):
    """Dedicated batch-1 greedy decode in the port."""
    state = T.init_decode_state(params, cfg, 1, 64)
    logits = None
    for t in prompt:
        logits, state = T.decode_step(params, cfg, state, torch.tensor([t]))
    out = []
    tok = int(torch.argmax(logits[0]))
    for _ in range(max_new):
        out.append(tok)
        logits, state = T.decode_step(params, cfg, state, torch.tensor([tok]))
        tok = int(torch.argmax(logits[0]))
    return out


def _reference_gaps(cfg, params, prompt, max_new):
    """The reference's dedicated greedy decode: tokens and top-2 gaps."""
    step = jax.jit(lambda p, s, t: JT.decode_step(p, cfg, s, t))
    state = JT.init_decode_state(params, cfg, 1, 64)
    for t in prompt:
        logits, state = step(params, state, jnp.asarray([t], jnp.int32))
    out, gaps = [], []
    for _ in range(max_new):
        lg = np.sort(np.asarray(logits[0]))
        gaps.append(float(lg[-1] - lg[-2]))
        out.append(int(jnp.argmax(logits[0])))
        logits, state = step(params, state, jnp.asarray([out[-1]], jnp.int32))
    return out, gaps


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_batcher_matches_requests_run_alone_and_the_reference(arch):
    cfg, tcfg, jp, tp = _models(arch, seed=4)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=p).astype(np.int32)
               for p in (5, 9, 7, 4)]
    max_new = 6
    batcher = ContinuousBatcher(tcfg, tp, batch_slots=2, max_len=64, device="cpu")
    ref = JaxBatcher(cfg, jp, batch_slots=2, max_len=64)
    for i, p in enumerate(prompts):
        batcher.submit(Request(rid=i, prompt=p, max_new=max_new))
        ref.submit(JaxRequest(rid=i, prompt=p, max_new=max_new))
    stats = batcher.run()
    ref_stats = ref.run()
    assert isinstance(stats, ServeStats)
    assert (stats.completed, stats.tokens_out, stats.decode_steps) == (
        ref_stats.completed, ref_stats.tokens_out, ref_stats.decode_steps)
    ref_out = {r.rid: r.out for r in ref.completed}
    for req in batcher.completed:
        assert req.out == _greedy_alone(tcfg, tp, prompts[req.rid], max_new), req.rid
        want, gaps = _reference_gaps(cfg, jp, prompts[req.rid], max_new)
        assert ref_out[req.rid] == want
        close = [i for i, g in enumerate(gaps) if g <= GAP]
        n = close[0] if close else max_new
        assert req.out[:n] == want[:n], (req.rid, gaps)
        assert req.first_token_at is not None and req.done_at >= req.submitted_at


def test_batcher_slot_reset_zeroes_the_slot():
    _, tcfg, _, tp = _models("yi-6b", seed=1)
    batcher = ContinuousBatcher(tcfg, tp, batch_slots=2, max_len=16, device="cpu")
    batcher.submit(Request(rid=0, prompt=np.array([1, 2, 3], np.int32), max_new=2))
    batcher.step()
    kv = batcher.state.layers["kv"]
    assert bool(kv.k[:, 0].abs().sum() > 0) and int(kv.length[0, 0]) == 1
    batcher._reset_slot_state(0)
    assert float(kv.k[:, 0].abs().sum()) == 0.0 and float(kv.v[:, 0].abs().sum()) == 0.0
    assert int(kv.length[:, 0].abs().sum()) == 0 and int(batcher.state.step[0]) == 0


@pytest.mark.parametrize("arch,names", [("rwkv6-3b", ["rwkv"]),
                                        ("hymba-1.5b", ["kv", "mamba"])])
def test_batcher_slot_reset_zeroes_the_recurrent_state(arch, names):
    """Every per-slot leaf (WKV state, both token shifts; K/V, Mamba state
    and conv buffer) is zeroed for the new request; the other slot keeps
    its own."""
    _, tcfg, _, tp = _models(arch, seed=1)
    batcher = ContinuousBatcher(tcfg, tp, batch_slots=2, max_len=16, device="cpu")
    for rid in range(2):
        batcher.submit(Request(rid=rid, prompt=np.array([1, 2, 3], np.int32), max_new=2))
    batcher.step()
    leaves = [leaf for name in names for leaf in batcher.state.layers[name]]
    assert sorted(batcher.state.layers) == names
    assert all(bool(leaf[:, 0].abs().sum() > 0) for leaf in leaves)
    kept = [leaf[:, 1].clone() for leaf in leaves]
    batcher._reset_slot_state(0)
    assert all(float(leaf[:, 0].abs().sum()) == 0.0 for leaf in leaves)
    assert all(torch.equal(leaf[:, 1], k) for leaf, k in zip(leaves, kept))
    assert int(batcher.state.step[0]) == 0 and int(batcher.state.step[1]) == 1
