"""The RWKV6 WKV op and RWKV6's time and channel mix in the port against the
JAX reference, on the CPU.

The port's op (what CPU tensors take: the plain version, the per-token
recurrence; the CUDA kernel is held to it on the card by ``chip_smoke.py``)
against ``repro``'s jnp oracle ``wkv6_ref`` and its chunked Pallas kernel in
interpret mode, at the reference test's four shapes.  Under a strong decay
(``logw = -exp(N(1, 1))``) the chunked form's ``exp(-cum)`` overflows and
the Pallas kernel's output is not finite, so those cases are held to the
oracle alone.  ``models/ssm.py``'s time mix (both routes of
``rwkv_time_mix_chunked``, and ``rwkv_time_mix_recurrent``), channel mix and
group norm run on RWKV6's smoke config from the reference's weights.

Tolerances: the op within 2e-6 * max(1, max |ref|) (fp32 sums over n rows
in another order; outputs reach ~90 at n = 64); the layers' outputs within
1e-5 (they are O(1)) and their states within 1e-5 * max(1, max |ref|) (the
WKV state grows to ~20 over 128 tokens); the norm 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.kernels.rwkv6.ops import wkv6 as jax_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref as jax_ref
from repro.models import ssm as JS
from repro_torch.configs import get_model_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.rwkv6 import kernel as rwkv6_kernel
from repro_torch.kernels.rwkv6.ops import wkv6, wkv6_heads
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models import ssm as S

OP_TOL = 2e-6
TOL = 1e-5

SHAPES = [(4, 128, 64, 64), (2, 256, 32, 64), (8, 64, 64, 32), (1, 64, 16, 16)]


def _inputs(bh, t, n, seed, decay_mean=-2.0, s0_scale=0.1):
    """The reference test's distributions; ``logw = -exp(N(decay_mean, 1))``."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(bh, t, n)).astype(np.float32) for _ in range(3))
    logw = (-np.exp(rng.normal(decay_mean, 1.0, size=(bh, t, n)))).astype(np.float32)
    u = (rng.normal(size=(bh, n)) * 0.1).astype(np.float32)
    s0 = (rng.normal(size=(bh, n, n)) * s0_scale).astype(np.float32)
    return r, k, v, logw, u, s0


def _port(fn, arrays):
    y, s = fn(*(torch.as_tensor(a) for a in arrays))
    return y.numpy(), s.numpy()


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, atol=OP_TOL * max(1.0, np.abs(want).max()),
                               rtol=0)


@pytest.mark.parametrize("bh,t,n,chunk", SHAPES)
def test_wkv6_matches_reference_and_pallas(bh, t, n, chunk):
    arrays = _inputs(bh, t, n, seed=bh * t)
    jarrays = [jnp.asarray(a) for a in arrays]
    want_y, want_s = jax_wkv6(*jarrays, impl="xla")
    pal_y, pal_s = jax_wkv6(*jarrays, impl="pallas", chunk=chunk)
    for fn in (wkv6, wkv6_ref):
        y, s = _port(fn, arrays)
        assert y.shape == (bh, t, n) and s.shape == (bh, n, n)
        assert y.dtype == np.float32 and s.dtype == np.float32
        for got, want in ((y, want_y), (s, want_s), (y, pal_y), (s, pal_s)):
            _close(got, want)


@pytest.mark.parametrize("bh,t,n,chunk", SHAPES)
def test_strong_decay_matches_the_oracle(bh, t, n, chunk):
    arrays = _inputs(bh, t, n, seed=bh * t + 1, decay_mean=1.0)
    jarrays = [jnp.asarray(a) for a in arrays]
    want_y, want_s = jax_ref(*jarrays)
    pal_y, _ = jax_wkv6(*jarrays, impl="pallas", chunk=chunk)
    assert not np.isfinite(np.asarray(pal_y)).all()   # the chunked form overflows
    y, s = _port(wkv6, arrays)
    assert np.isfinite(y).all() and np.isfinite(s).all()
    _close(y, want_y)
    _close(s, want_s)


@pytest.mark.parametrize("t", [1, 7, 65])
def test_ragged_lengths_match_the_oracle(t):
    arrays = _inputs(3, t, 32, seed=t)
    want_y, want_s = jax_ref(*map(jnp.asarray, arrays))
    y, s = _port(wkv6, arrays)
    _close(y, want_y)
    _close(s, want_s)


def test_state_carry_composes():
    """[0:T] equals [0:h] then [h:T] from the carried state."""
    r, k, v, logw, u, _ = _inputs(2, 128, 32, seed=5)
    s0 = np.zeros((2, 32, 32), np.float32)
    y_full, s_full = _port(wkv6, (r, k, v, logw, u, s0))
    h = 45
    y1, s1 = _port(wkv6, (r[:, :h], k[:, :h], v[:, :h], logw[:, :h], u, s0))
    y2, s2 = _port(wkv6, (r[:, h:], k[:, h:], v[:, h:], logw[:, h:], u, s1))
    _close(np.concatenate([y1, y2], 1), y_full)
    _close(s2, s_full)


def test_model_layout_equals_the_folded_layout():
    """``wkv6_heads`` on (B, T, H, n) views with u shared by the batch equals
    ``wkv6`` on the heads folded into the batch."""
    b, t, h, n = 2, 9, 3, 16
    rng = np.random.default_rng(7)
    r, k, v = (torch.as_tensor(rng.normal(size=(b, t, h * n)).astype(np.float32))
               for _ in range(3))
    logw = -torch.exp(torch.as_tensor(rng.normal(-2, 1, size=(b, t, h * n)).astype(np.float32)))
    u = torch.as_tensor((rng.normal(size=(h, n)) * 0.1).astype(np.float32))
    s0 = torch.as_tensor(rng.normal(size=(b, h, n, n)).astype(np.float32))
    heads = [a.reshape(b, t, h, n) for a in (r, k, v, logw)]
    y, s = wkv6_heads(*heads, u, s0)

    def fold(a):
        return a.permute(0, 2, 1, 3).reshape(b * h, t, n)

    yf, sf = wkv6(*(fold(a) for a in heads), u.repeat(b, 1), s0.reshape(b * h, n, n))
    np.testing.assert_allclose(y.permute(0, 2, 1, 3).reshape(b * h, t, n).numpy(),
                               yf.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(s.reshape(b * h, n, n).numpy(), sf.numpy(), atol=1e-6, rtol=0)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    rwkv6_kernel.wkv6_cuda.launches = 0
    _port(wkv6, _inputs(1, 5, 8, seed=0))
    assert rwkv6_kernel.wkv6_cuda.launches == 0


# ---------------------------------------------------------------------------
# RWKV6's time and channel mix (models/ssm.py)
# ---------------------------------------------------------------------------


def _rwkv(seed=0):
    cfg = jax_config("rwkv6-3b", smoke=True)
    key = jax.random.PRNGKey(seed)
    jp = {"time_mix": JS.init_rwkv_time_mix(key, cfg, jnp.float32),
          "channel_mix": JS.init_rwkv_channel_mix(jax.random.fold_in(key, 1), cfg,
                                                   jnp.float32)}
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, get_model_config("rwkv6-3b", smoke=True), jp, tp


def _state(cfg, b, seed):
    h, n = JS.rwkv_dims(cfg)
    rng = np.random.default_rng(seed)
    arrays = ((rng.normal(size=(b, h, n, n)) * 0.1).astype(np.float32),
              rng.normal(size=(b, cfg.d_model)).astype(np.float32),
              rng.normal(size=(b, cfg.d_model)).astype(np.float32))
    return (JS.RWKVState(*map(jnp.asarray, arrays)),
            S.RWKVState(*map(torch.as_tensor, arrays)))


def _same_state(got, want):
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, atol=TOL * max(1.0, np.abs(w).max()),
                                   rtol=0)


@pytest.mark.parametrize("t", [64, 128, 37])
def test_time_mix_chunked_routes_match(t):
    """From a carried state: the reference's chunked form (its recurrence
    when ``t % 64``) against both of the port's routes."""
    cfg, tcfg, jp, tp = _rwkv(1)
    x = np.random.default_rng(t).normal(size=(2, t, cfg.d_model)).astype(np.float32)
    jst, tst = _state(cfg, 2, seed=t)
    want, wst = JS.rwkv_time_mix_chunked(jp["time_mix"], jnp.asarray(x), jst, cfg)
    for impl in ("xla", "cuda"):
        got, gst = S.rwkv_time_mix_chunked(tp["time_mix"], torch.as_tensor(x), tst, tcfg,
                                           impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
        _same_state(gst, wst)
    with pytest.raises(ValueError, match="unknown mixer impl"):
        S.rwkv_time_mix_chunked(tp["time_mix"], torch.as_tensor(x), tst, tcfg,
                                impl="pallas")


def test_time_mix_recurrent_matches():
    cfg, tcfg, jp, tp = _rwkv(2)
    x = np.random.default_rng(2).normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    jst, tst = _state(cfg, 2, seed=2)
    want, wst = JS.rwkv_time_mix_recurrent(jp["time_mix"], jnp.asarray(x), jst, cfg)
    got, gst = S.rwkv_time_mix_recurrent(tp["time_mix"], torch.as_tensor(x), tst, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    _same_state(gst, wst)
    # one token at a time continues the same recurrence
    st = _state(cfg, 2, seed=2)[1]
    for i in range(9):
        out, st = S.rwkv_time_mix_recurrent(tp["time_mix"], torch.as_tensor(x[:, i:i + 1]),
                                            st, tcfg)
        np.testing.assert_allclose(out.numpy()[:, 0], np.asarray(want[:, i]), atol=TOL,
                                   rtol=0)
    _same_state(st, wst)


def test_channel_mix_matches():
    cfg, _, jp, tp = _rwkv(3)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, cfg.d_model)).astype(np.float32)
    last = rng.normal(size=(2, cfg.d_model)).astype(np.float32)
    want, wlast = JS.rwkv_channel_mix(jp["channel_mix"], jnp.asarray(x), jnp.asarray(last))
    got, glast = S.rwkv_channel_mix(tp["channel_mix"], torch.as_tensor(x),
                                    torch.as_tensor(last))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
    np.testing.assert_array_equal(glast.numpy(), np.asarray(wlast))


def test_group_norm_matches():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 5, 96)) * 3).astype(np.float32)
    scale = rng.normal(size=96).astype(np.float32)
    want = JS._group_norm(jnp.asarray(x), jnp.asarray(scale), 6, 16)
    got = S._group_norm(torch.as_tensor(x), torch.as_tensor(scale), 6, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


def test_init_rwkv_layout_and_distributions():
    cfg, tcfg, jp, _ = _rwkv(0)
    gen = torch.Generator().manual_seed(0)
    got = {"time_mix": S.init_rwkv_time_mix(gen, tcfg, torch.float32, lead=(2,)),
           "channel_mix": S.init_rwkv_channel_mix(gen, tcfg, torch.float32, lead=(2,))}
    want = jax.tree.map(lambda a: ((2,) + a.shape, str(a.dtype)), jp)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                        got) == want
    tm = got["time_mix"]
    assert bool((tm["w0"] == -6).all()) and bool((tm["mu"] == 0.5).all())
    assert bool((tm["ln_x_scale"] == 1).all())
    big = S.init_rwkv_time_mix(gen, get_model_config("rwkv6-3b", smoke=True), torch.float32,
                               lead=(8,))
    assert abs(float(big["u"].std()) - 0.1) < 0.01
    assert abs(float(big["w_lora_b"].std()) - 0.01) < 1e-3
    st = S.init_rwkv_state(tcfg, 3, torch.device("cpu"), lead=(2,))
    jst = JS.init_rwkv_state(cfg, 3)
    assert [tuple(a.shape) for a in st] == [(2,) + a.shape for a in jst]


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic, emulated in numpy fp32 (csrc/rwkv6.cu)
# ---------------------------------------------------------------------------

KERNEL_TOL = 2e-5          # chip_smoke.py's SSM_TOL: x max(1, max |ref|) of the row


def _fma32(a, b, c):
    """fp32 fused multiply-add: the exact product and sum, rounded once (to
    fp64, then fp32; the double rounding is far below the tolerance)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _wkv6_fp64(r, k, v, logw, u, s0):
    """The plain version's recurrence in fp64, on the same fp32 inputs."""
    r, k, v, logw, u, S = (a.astype(np.float64) for a in (r, k, v, logw, u, s0))
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, None] * v[:, t, None, :]
        ys.append(np.einsum("bi,bij->bj", r[:, t], S + u[..., None] * kv))
        S = np.exp(logw[:, t])[..., None] * S + kv
    return np.stack(ys, 1), S


def _wkv6_kernel_emulation(r, k, v, logw, u, s0, nmax, rgw, warps, pg):
    """rwkv6.cu's order of fp32 operations for a head's rows padded to
    ``nmax``, ``rgw`` row groups of 4 a warp, ``warps`` warps a CTA, ``pg``
    threads a token in the pack: each thread's y partial over its 4 rows as
    an FMA chain, the reduce-scatter adding row groups in pairs inside the
    warp, warp 0 adding the bonus weight times v, the warps' partials added
    in warp order; S = fma(w, S, k v) with w = expf(logw), computed once per
    (token, row); the bonus weight sum_i r u k as each pack thread's FMA
    chain over its float4s of rows (q = thread, thread + pg, ...), then a
    butterfly over the pg threads."""
    bh, t, n = r.shape
    pad = [(0, 0), (0, 0), (0, nmax - n)]
    r, k, v, logw = (np.pad(a, pad) for a in (r, k, v, logw))
    u = np.pad(u, [(0, 0), (0, nmax - n)])
    S = np.pad(s0, [(0, 0), (0, nmax - n), (0, nmax - n)])
    ys = np.empty((bh, t, nmax), np.float32)
    for tt in range(t):
        w = np.exp(logw[:, tt])                                    # fp32 expf
        ru = (r[:, tt] * u).reshape(bh, nmax // 4 // pg, pg, 4)    # [q // pg, gi, elem]
        kq = k[:, tt].reshape(bh, nmax // 4 // pg, pg, 4)
        acc = np.zeros((bh, pg), np.float32)
        for q in range(ru.shape[1]):
            for e in range(4):
                acc = _fma32(ru[:, q, :, e], kq[:, q, :, e], acc)
        for off in (16, 8, 4, 2, 1):
            if off < pg:
                acc = acc + acc[:, np.arange(pg) ^ off]
        ruk = acc[:, 0]
        rg = r[:, tt].reshape(bh, nmax // 4, 4)                    # (bh, groups, 4)
        Sg = S.reshape(bh, nmax // 4, 4, nmax)
        part = rg[:, :, 0, None] * Sg[:, :, 0]
        for i in range(1, 4):
            part = _fma32(rg[:, :, i, None], Sg[:, :, i], part)   # (bh, groups, nmax)
        part = part.reshape(bh, warps, rgw, nmax)
        while part.shape[2] > 1:                                   # pairs, then quads
            part = part[:, :, 0::2] + part[:, :, 1::2]
        red = part[:, :, 0]                                        # (bh, warps, nmax)
        y = _fma32(ruk[:, None], v[:, tt], red[:, 0])
        for q in range(1, warps):
            y = y + red[:, q]
        ys[:, tt] = y
        kv = k[:, tt, :, None] * v[:, tt, None, :]
        S = _fma32(w[..., None], S, kv)
    return ys[..., :n], S[:, :n, :n]


def _rows_within(got, want, axes):
    scale = np.maximum(1.0, np.abs(want).max(axis=axes, keepdims=True))
    err = np.abs(got.astype(np.float64) - want)
    assert np.isfinite(got).all() and (err <= KERNEL_TOL * scale).all(), float(err.max())
    return float((err / (KERNEL_TOL * scale)).max())


# (row groups a warp, warps, pack threads a token) of each instantiation by
# NMAX: <16,1,4>; <32,1,4>; <64,2,4> and <64,2,2> (4 x 2 tiles: 2 row groups
# a warp)
KERNEL_SHAPES = {16: [(4, 1, 1)], 32: [(4, 2, 4)], 64: [(4, 4, 8), (2, 8, 16)]}


@pytest.mark.parametrize("decay_mean", [-6.0, -2.0, 1.0], ids=["model", "mild", "strong"])
@pytest.mark.parametrize("n", [5, 16, 32, 48, 64])
def test_kernel_order_of_operations_meets_the_card_tolerance(n, decay_mean):
    """A numpy fp32 emulation of the kernel's summation order (row-group
    partials, their reduce-scatter and warp-order tree, the bonus term, the
    per-chunk decays) within the card's 2e-5 * max(1, |ref|) row tolerance
    of an fp64 evaluation of the plain version, for every instantiation
    that takes width n, under the model's, a mild and a strong decay."""
    r, k, v, logw, u, s0 = _inputs(3, 48, n, seed=n, decay_mean=decay_mean, s0_scale=1.0)
    want_y, want_s = _wkv6_fp64(r, k, v, logw, u, s0)
    nmax = 16 if n <= 16 else 32 if n <= 32 else 64
    for shape in KERNEL_SHAPES[nmax]:
        y, s = _wkv6_kernel_emulation(r, k, v, logw, u, s0, nmax, *shape)
        _rows_within(y, want_y, (1, 2))
        _rows_within(s, want_s, (1, 2))
