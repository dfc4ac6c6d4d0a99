"""The three model kernels as dispatcher ops, on the CPU.

``repro_torch::flash_attention``, ``repro_torch::selective_scan`` and
``repro_torch::wkv6`` (``kernels/<name>/ops.py``):

* ``torch.library.opcheck`` passes (schema, fake tensors, dispatch under
  AOT with dynamic shapes), T = 0 included;
* on CPU tensors each op gives its plain version's output bit for bit, and
  on meta tensors the plain version's output shapes and dtypes;
* the fake implementation refuses what the CUDA wrapper refuses without
  data (ranks, shapes, dtypes, the kernels' limits, layouts), and takes the
  largest shapes inside the limits;
* inputs that require grad still raise;
* ``analyze_step`` on meta tensors counts each op's work by its formula
  (``kernels/work.py``), held to a count by hand: flash attention's pairs by
  brute force over the mask at a causal, a windowed and a GQA shape;
* each op on the CPU agrees with the reference's op, run as its own tests
  run it (the Pallas kernel in interpret mode), on the same numpy inputs, at
  the tolerances of ``test_torch_{flash_attention,mamba,rwkv6}.py``.

The CUDA implementations are the launches that ``chip_smoke.py`` holds, on
the card, bit-equal to the direct ``*_cuda`` calls with one launch a call.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.mamba.ops import selective_scan as jax_scan
from repro.kernels.rwkv6.ops import wkv6 as jax_wkv6
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba import ops as mamba_ops
from repro_torch.kernels.mamba.ref import selective_scan_ref
from repro_torch.kernels.rwkv6 import ops as rwkv_ops
from repro_torch.kernels.rwkv6.ref import wkv6_heads_ref
from repro_torch.kernels.work import flash_pairs, scan_ops, wkv_ops
from repro_torch.launch.hlo_cost import analyze_step

FA_TOL = 1e-5        # test_torch_flash_attention.py, fp32
SCAN_TOL = 1e-5      # test_torch_mamba.py
WKV_TOL = 2e-6       # test_torch_rwkv6.py's OP_TOL, x max(1, max |ref|)


def _flash_arrays(b, s, h, kv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, dh)).astype(np.float32) for n in (h, kv, kv)]


def _scan_arrays(b, t, inner, state, seed):
    """The reference test's distributions: dt ~ |N(0.05, 0.02)|, A < 0."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, inner)).astype(np.float32),
            np.abs(rng.normal(0.05, 0.02, size=(b, t, inner))).astype(np.float32),
            rng.normal(size=(b, t, state)).astype(np.float32),
            rng.normal(size=(b, t, state)).astype(np.float32),
            (-np.abs(rng.normal(1, 0.5, size=(inner, state)))).astype(np.float32),
            (rng.normal(size=(b, inner, state)) * 0.1).astype(np.float32))


def _wkv_arrays(b, t, h, n, seed):
    """The model's layout, the reference test's distributions."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, n)).astype(np.float32) for _ in range(3))
    logw = (-np.exp(rng.normal(-2.0, 1.0, size=(b, t, h, n)))).astype(np.float32)
    return (r, k, v, logw, (rng.normal(size=(h, n)) * 0.1).astype(np.float32),
            (rng.normal(size=(b, h, n, n)) * 0.1).astype(np.float32))


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


# op -> (sample inputs, the plain version on them); T = 0 and a window too
SAMPLES = {
    "flash-causal": (fa_ops.OP, lambda: (*_t(_flash_arrays(2, 9, 4, 2, 8, 0)), True, None)),
    "flash-window": (fa_ops.OP, lambda: (*_t(_flash_arrays(1, 12, 3, 1, 16, 1)), True, 4)),
    "flash-bidirectional": (fa_ops.OP,
                            lambda: (*_t(_flash_arrays(2, 5, 2, 2, 8, 2)), False, None)),
    "scan": (mamba_ops.OP, lambda: _t(_scan_arrays(2, 7, 6, 4, 3))),
    "scan-t0": (mamba_ops.OP, lambda: _t(_scan_arrays(2, 0, 6, 4, 4))),
    "wkv6": (rwkv_ops.OP, lambda: _t(_wkv_arrays(2, 5, 3, 4, 5))),
    "wkv6-t0": (rwkv_ops.OP, lambda: _t(_wkv_arrays(2, 0, 3, 4, 6))),
}


def _plain(name, args):
    if name.startswith("flash"):
        q, k, v, causal, window = args
        return (attention_ref(q, k, v, causal=causal, window=window),)
    if name.startswith("scan"):
        return selective_scan_ref(*args)
    return wkv6_heads_ref(*args)


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", SAMPLES)
def test_opcheck(name):
    op, sample = SAMPLES[name]
    torch.library.opcheck(op, sample())


@pytest.mark.parametrize("name", SAMPLES)
def test_op_on_cpu_is_the_plain_version_bit_for_bit(name):
    op, sample = SAMPLES[name]
    args = sample()
    got, want = _outs(op(*args)), _plain(name, args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.is_contiguous() and torch.equal(g, w)
    # and none aliases an input (T = 0 hands back the initial state's values)
    ptrs = {a.untyped_storage().data_ptr() for a in args if isinstance(a, torch.Tensor)}
    assert all(g.untyped_storage().data_ptr() not in ptrs for g in got if g.numel())


@pytest.mark.parametrize("name", SAMPLES)
def test_op_on_meta_tensors_gives_the_plain_shapes(name):
    op, sample = SAMPLES[name]
    args = sample()
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    got, want = _outs(op(*meta)), _plain(name, args)
    assert [(g.shape, g.dtype, g.device.type) for g in got] == \
        [(w.shape, w.dtype, "meta") for w in want]


def _meta(*shapes, dtype=torch.float32):
    return [torch.empty(s, dtype=dtype, device="meta") for s in shapes]


def _fa(b=1, s=4, h=2, kv=1, dh=8, dtype=torch.float32):
    """The op's arguments: q, k, v on meta tensors, causal, no window."""
    return _meta((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh), dtype=dtype) + [True, None]


def _sc(b=1, t=3, inner=4, state=2):
    return _meta((b, t, inner), (b, t, inner), (b, t, state), (b, t, state),
                 (inner, state), (b, inner, state))


def _wk(b=1, t=3, h=2, n=4, dtype=torch.float32):
    return _meta((b, t, h, n), (b, t, h, n), (b, t, h, n), (b, t, h, n), (h, n),
                 (b, h, n, n), dtype=dtype)


def _swap(args, i, t):
    args = list(args)
    args[i] = t
    return args


def _strided(shape):
    """A meta tensor of ``shape`` whose last dimension is not contiguous."""
    return torch.empty(shape[:-1] + (2 * shape[-1],), device="meta")[..., ::2]


# (op, inputs on meta tensors, the message of the CUDA wrapper's refusal)
REFUSED = {
    "flash-rank": (fa_ops.OP, lambda: [_fa()[0][0], *_fa()[1:]], "takes q"),
    "flash-kv-shape": (fa_ops.OP, lambda: _swap(_fa(), 2, _meta((1, 4, 1, 4))[0]),
                       "do not match"),
    "flash-groups": (fa_ops.OP, lambda: _fa(h=3, kv=2), "do not split"),
    "flash-window0": (fa_ops.OP, lambda: _swap(_fa(), 4, 0), "window must be"),
    "flash-fp16": (fa_ops.OP, lambda: _fa(dtype=torch.float16), "kernel takes"),
    "flash-mixed-dtype": (fa_ops.OP, lambda: _swap(_fa(), 1, _meta((1, 4, 1, 8),
                                                                   dtype=torch.bfloat16)[0]),
                          "share a dtype"),
    "flash-g65": (fa_ops.OP, lambda: _fa(h=65, kv=1), "H / KV <= 64"),
    "flash-dh257": (fa_ops.OP, lambda: _fa(dh=257), "Dh <= 256"),
    "flash-b65536": (fa_ops.OP, lambda: _fa(b=65536), "B, KV <= 65535"),
    "flash-kv65536": (fa_ops.OP, lambda: _fa(h=65536, kv=65536), "B, KV <= 65535"),
    "flash-strided": (fa_ops.OP, lambda: _swap(_fa(), 0, _strided((1, 4, 2, 8))),
                      "contiguous"),
    "scan-fp64": (mamba_ops.OP, lambda: [a.double() for a in _sc()], "float32"),
    "scan-rank": (mamba_ops.OP, lambda: _swap(_sc(), 0, _meta((3, 4))[0]), "must be"),
    "scan-dt-shape": (mamba_ops.OP, lambda: _swap(_sc(), 1, _meta((1, 3, 5))[0]), "shape"),
    "scan-state65": (mamba_ops.OP, lambda: _sc(state=65), "state <= 64"),
    "scan-b65536": (mamba_ops.OP, lambda: _sc(b=65536), "B <= 65535"),
    "scan-a-strided": (mamba_ops.OP, lambda: _swap(_sc(), 4, _strided((4, 2))),
                       "A contiguous"),
    "wkv-bf16": (rwkv_ops.OP, lambda: _wk(dtype=torch.bfloat16), "float32"),
    "wkv-rank": (rwkv_ops.OP, lambda: _swap(_wk(), 0, _meta((3, 2, 4))[0]), r"\(B, T, H, n\)"),
    "wkv-k-shape": (rwkv_ops.OP, lambda: _swap(_wk(), 1, _meta((1, 3, 2, 5))[0]), "shape"),
    "wkv-u-shape": (rwkv_ops.OP, lambda: _swap(_wk(), 4, _meta((3, 4))[0]), "u has shape"),
    "wkv-n65": (rwkv_ops.OP, lambda: _wk(n=65), "n <= 64"),
    "wkv-heads": (rwkv_ops.OP, lambda: _wk(b=2 ** 15, t=1, h=2 ** 15, n=1), "B \\* H <="),
    "wkv-s0-strided": (rwkv_ops.OP, lambda: _swap(_wk(), 5, _strided((1, 2, 4, 4))),
                       "s0 contiguous"),
}


@pytest.mark.parametrize("name", REFUSED)
def test_fake_refuses_what_the_kernel_refuses(name):
    op, args, msg = REFUSED[name]
    with pytest.raises(ValueError, match=msg):
        op(*args())


@pytest.mark.parametrize("op,args", [
    (fa_ops.OP, lambda: _fa(h=64, kv=1, dh=256, b=65535)),
    (fa_ops.OP, lambda: _fa(h=2, kv=2, dtype=torch.bfloat16)),
    (mamba_ops.OP, lambda: _sc(b=65535, state=64)),
    (rwkv_ops.OP, lambda: _wk(n=64)),
], ids=["flash", "flash-bf16", "scan", "wkv"])
def test_fake_takes_the_largest_shapes_inside_the_limits(op, args):
    out = _outs(op(*args()))
    assert all(o.device.type == "meta" for o in out)


@pytest.mark.parametrize("fn,args", [
    (lambda *a: fa_ops.flash_attention(*a), lambda: _t(_flash_arrays(1, 4, 2, 1, 8, 7))),
    (mamba_ops.selective_scan, lambda: _t(_scan_arrays(1, 3, 4, 2, 8))),
    (rwkv_ops.wkv6_heads, lambda: _t(_wkv_arrays(1, 3, 2, 4, 9))),
    (rwkv_ops.wkv6, lambda: [torch.zeros(3, 2, 4) for _ in range(4)]
     + [torch.zeros(3, 4), torch.zeros(3, 4, 4)]),
], ids=["flash", "scan", "wkv6_heads", "wkv6"])
def test_inputs_that_require_grad_still_raise(fn, args):
    a = args()
    a[0].requires_grad_(True)
    with pytest.raises(ValueError, match="no backward"):
        fn(*a)
    with torch.no_grad():
        fn(*a)


def _pairs_by_brute_force(s, causal, window):
    i, j = np.meshgrid(np.arange(s), np.arange(s), indexing="ij")
    seen = np.ones((s, s), bool)
    if causal:
        seen &= j <= i
    if window:
        seen &= j > i - window
    return int(seen.sum())


@pytest.mark.parametrize("s", [1, 2, 7, 64, 65])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 4, 64, 100])
def test_flash_pairs_closed_form(s, causal, window):
    assert flash_pairs(s, causal, window) == _pairs_by_brute_force(s, causal, window)


# (b, s, h, kv, dh, causal, window)
FLOP_CASES = {"causal": (2, 37, 4, 4, 16, True, None),
              "windowed": (1, 50, 2, 2, 32, True, 9),
              "gqa": (3, 20, 8, 2, 8, False, None)}


@pytest.mark.parametrize("case", FLOP_CASES)
def test_counter_books_flash_work_by_the_formula(case):
    b, s, h, kv, dh, causal, window = FLOP_CASES[case]
    q, k, v = _meta((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh))
    cost = analyze_step(fa_ops.flash_attention, q, k, v, causal=causal, window=window)
    want = 2 * 2 * dh * _pairs_by_brute_force(s, causal, window) * b * h
    assert cost.dot_flops == cost.flops == want
    assert cost.bytes == 4 * (2 * b * s * h * dh + 2 * b * s * kv * dh)
    assert cost.kernel_calls == {"repro_torch::flash_attention": 1}


def test_counter_books_scan_work_as_flops_only():
    b, t, inner, state = 2, 3, 4, 5
    cost = analyze_step(mamba_ops.selective_scan, *_sc(b, t, inner, state))
    # per (b, t, c): 7 operations per state entry, one for dt * x
    assert cost.flops == b * t * inner * (7 * state + 1) == 864 == scan_ops(b, t, inner, state)
    assert cost.dot_flops == 0
    assert cost.bytes == 4 * (3 * b * t * inner + 2 * b * t * state + inner * state
                              + 2 * b * inner * state)
    assert cost.kernel_calls == {"repro_torch::selective_scan": 1}


def test_counter_books_wkv_work_as_flops_only():
    b, t, h, n = 2, 3, 2, 4
    cost = analyze_step(rwkv_ops.wkv6_heads, *_wk(b, t, h, n))
    # per (b, t, head): 5 n^2 for r.S, w S + k v and the bonus, 4 n more
    assert cost.flops == b * t * h * (5 * n * n + 4 * n) == 1152 == wkv_ops(b, t, h, n)
    assert cost.dot_flops == 0
    assert cost.bytes == 4 * (5 * b * t * h * n + h * n + 2 * b * h * n * n)
    assert cost.kernel_calls == {"repro_torch::wkv6": 1}


@pytest.mark.parametrize("case", [(1, 32, 8, 1, 128, True, None), (1, 32, 8, 2, 64, True, 8),
                                  (2, 128, 1, 1, 32, False, 32)],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_op_agrees_with_the_reference_op(case):
    b, s, h, kv, dh, causal, window = case
    arrays = _flash_arrays(b, s, h, kv, dh, seed=s + h)
    want = np.asarray(jax_flash(*map(jnp.asarray, arrays), causal=causal, window=window))
    got = fa_ops.OP(*_t(arrays), causal, window).numpy()
    np.testing.assert_allclose(got, want, atol=FA_TOL, rtol=0)


def test_scan_op_agrees_with_the_reference_op():
    arrays = _scan_arrays(2, 128, 96, 16, seed=11)
    want = jax_scan(*map(jnp.asarray, arrays), impl="pallas", chunk=64)
    for got, w in zip(mamba_ops.OP(*_t(arrays)), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=SCAN_TOL, rtol=0)


def test_wkv6_op_agrees_with_the_reference_op():
    b, t, h, n = 2, 64, 2, 16
    arrays = _wkv_arrays(b, t, h, n, seed=12)
    r, k, v, logw, u, s0 = arrays

    def fold(a):                      # (B, T, H, n) -> the reference's (BH, T, n)
        return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b * h, t, n))

    ref = (fold(r), fold(k), fold(v), fold(logw), np.tile(u, (b, 1)),
           s0.reshape(b * h, n, n))
    want_y, want_s = jax_wkv6(*map(jnp.asarray, ref), impl="pallas", chunk=16)
    y, s = rwkv_ops.OP(*_t(arrays))
    for got, w in ((fold(y.numpy()), want_y), (s.numpy().reshape(b * h, n, n), want_s)):
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, atol=WKV_TOL * max(1.0, np.abs(w).max()), rtol=0)
