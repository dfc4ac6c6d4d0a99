"""The port's decode step against the JAX reference, on the CPU: a pure
``decode_step``, the in-place routine the serving loops call, and SSM decode
through the kernels' ops.

* ``decode_step`` leaves its input state as it was: from one primed state,
  two calls with the same token give the reference's logits both times, and
  the state's tensors equal their clones afterwards (dense, hybrid and
  attention-free smoke models).
* ``_decode_step_into`` (what ``serve`` and ``ContinuousBatcher`` call)
  gives the same logits and writes the state's caches in place.
* Decode at T = 1 goes through the ``wkv6_heads`` and ``selective_scan``
  ops (which take their plain versions for CPU tensors and launch the
  kernels for CUDA ones), once per layer and step.

Tolerance: the logits within 1e-4 of the reference's, as in
``tests/test_torch_lm.py``; the two routes of the port exactly equal (the
same arithmetic on the same device).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.models import transformer as JT
from repro_torch.configs import get_model_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch import scheduler as sched_lib
from repro_torch.launch import serve as serve_lib
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T

ARCHS = ["yi-6b", "hymba-1.5b", "rwkv6-3b"]
TOL = 1e-4


def _models(arch, seed=11):
    cfg = jax_config(arch, smoke=True)
    tcfg = get_model_config(arch, smoke=True)
    jp = JT.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _primed(arch, prompt=24, total=32):
    """Both packages' states after the same prompt, and the next tokens."""
    cfg, tcfg, jp, tp = _models(arch)
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, total)).astype(np.int32)
    _, jst = JT.prefill(jp, cfg, jnp.asarray(tok[:, :prompt]), max_len=total)
    _, tst = T.prefill(tp, tcfg, torch.as_tensor(tok[:, :prompt]), max_len=total,
                       impl="flash")
    return cfg, tcfg, jp, tp, jst, tst, tok[:, prompt:]


def _leaves(state):
    return [t for c in state.layers.values() for t in c] + [state.step]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_leaves_its_input_state_alone(arch):
    cfg, tcfg, jp, tp, jst, tst, nxt = _primed(arch)
    want, _ = jax.jit(lambda p, s, t: JT.decode_step(p, cfg, s, t))(
        jp, jst, jnp.asarray(nxt[:, 0]))
    before = [t.clone() for t in _leaves(tst)]
    token = torch.as_tensor(nxt[:, 0])
    first, new = T.decode_step(tp, tcfg, tst, token)
    second, _ = T.decode_step(tp, tcfg, tst, token)
    for got in (first, second):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=TOL,
                                   rtol=0)
    for t, c in zip(_leaves(tst), before):
        torch.testing.assert_close(t, c, rtol=0, atol=0)
    # the new state moved on, in tensors of its own
    np.testing.assert_array_equal(new.step.numpy(), tst.step.numpy() + 1)
    assert not any(a.data_ptr() == b.data_ptr() for a, b in zip(_leaves(new), _leaves(tst)))


@pytest.mark.parametrize("arch", ARCHS)
def test_in_place_routine_matches_decode_step(arch):
    _, tcfg, _, tp, _, tst, nxt = _primed(arch)
    pure_state, into_state = tst, T.DecodeState(
        {name: type(c)(*(t.clone() for t in c)) for name, c in tst.layers.items()},
        tst.step.clone())
    for i in range(nxt.shape[1]):
        token = torch.as_tensor(nxt[:, i])
        want, pure_state = T.decode_step(tp, tcfg, pure_state, token)
        ptrs = [t.data_ptr() for c in into_state.layers.values() for t in c]
        got, into_state = T._decode_step_into(tp, tcfg, into_state, token)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert ptrs == [t.data_ptr() for c in into_state.layers.values() for t in c]
    for a, b in zip(_leaves(into_state), _leaves(pure_state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("arch,op", [("rwkv6-3b", "wkv6_heads"),
                                     ("hymba-1.5b", "selective_scan")])
def test_ssm_decode_goes_through_the_kernel_ops(arch, op, monkeypatch):
    _, tcfg, _, tp, _, tst, nxt = _primed(arch)
    real = getattr(S, op)
    seen = []

    def spy(*args):
        seen.append(args[0].shape[1])         # T of (B, T, ...)
        return real(*args)

    monkeypatch.setattr(S, op, spy)
    for ref in ("wkv6_heads_ref", "selective_scan_ref"):
        monkeypatch.setattr(S, ref, lambda *a, _n=ref: pytest.fail(f"decode ran {_n}"))
    state = tst
    for i in range(3):
        _, state = T.decode_step(tp, tcfg, state, torch.as_tensor(nxt[:, i]))
    assert seen == [1] * (3 * tcfg.n_layers)


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_serving_loops_use_the_in_place_routine(arch, monkeypatch):
    calls = []
    real = T._decode_step_into

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(T, "_decode_step_into", spy)
    monkeypatch.setattr(T, "decode_step",
                        lambda *a: pytest.fail("a serving loop called decode_step"))
    serve_lib.serve(arch, smoke=True, batch=2, prompt_len=8, gen=3, temperature=0.0,
                    verbose=False, device="cpu")
    assert len(calls) == 3
    cfg = get_model_config(arch, smoke=True)
    params = T.init_params(0, cfg, "cpu")
    batcher = sched_lib.ContinuousBatcher(cfg, params, batch_slots=2, max_len=32,
                                          device="cpu")
    for rid in range(3):
        batcher.submit(sched_lib.Request(rid=rid, prompt=np.arange(1, 4, dtype=np.int32),
                                         max_new=2))
    stats = batcher.run()
    assert stats.completed == 3 and len(calls) == 3 + stats.decode_steps
