"""The Mamba selective scan and Hymba's Mamba heads in the port against the
JAX reference, on the CPU.

The port's op (what CPU tensors take: the plain version; the CUDA kernel is
held to the plain version on the card by ``chip_smoke.py``) and its plain
version against ``repro``'s jnp oracle (``selective_scan(impl="xla")``) and
its Pallas kernel in interpret mode (``impl="pallas"``), at the reference
test's shapes.  The Pallas wrapper needs T to be a multiple of its chunk;
ragged T, which the CUDA kernel takes, is held to the oracle alone.
``models/ssm.py``'s ``_mamba_preproc`` and ``mamba_scan`` (both routes,
prefill and the one-token decode step, with a carried conv buffer and state)
run on Hymba's smoke config from the reference's weights.

Tolerance: 1e-5 (fp32 sums and exps in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as jax_config
from repro.kernels.mamba.ops import selective_scan as jax_scan
from repro.kernels.mamba.ref import selective_scan_ref as jax_ref
from repro.models import ssm as JS
from repro_torch.configs import get_model_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.mamba import kernel as mamba_kernel
from repro_torch.kernels.mamba.ops import selective_scan
from repro_torch.kernels.mamba.ref import selective_scan_ref
from repro_torch.models import ssm as S

TOL = 1e-5


def _inputs(b, t, inner, state, seed, h0_scale=0.1):
    """The reference test's distributions: dt ~ |N(0.05, 0.02)|, A < 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, t, inner)).astype(np.float32)
    dt = np.abs(rng.normal(0.05, 0.02, size=(b, t, inner))).astype(np.float32)
    bm = rng.normal(size=(b, t, state)).astype(np.float32)
    cm = rng.normal(size=(b, t, state)).astype(np.float32)
    a = (-np.abs(rng.normal(1, 0.5, size=(inner, state)))).astype(np.float32)
    h0 = (rng.normal(size=(b, inner, state)) * h0_scale).astype(np.float32)
    return x, dt, bm, cm, a, h0


def _port(fn, arrays):
    y, h = fn(*(torch.as_tensor(a) for a in arrays))
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("b,t,inner,state,chunk", [
    (2, 128, 96, 16, 64), (1, 64, 100, 16, 32), (2, 128, 128, 8, 64)])
def test_selective_scan_matches_reference_and_pallas(b, t, inner, state, chunk):
    arrays = _inputs(b, t, inner, state, seed=b * t + inner)
    jarrays = [jnp.asarray(a) for a in arrays]
    want_y, want_h = (np.asarray(a) for a in jax_scan(*jarrays, impl="xla"))
    pal_y, pal_h = (np.asarray(a) for a in jax_scan(*jarrays, impl="pallas", chunk=chunk))
    for fn in (selective_scan, selective_scan_ref):
        y, h = _port(fn, arrays)
        assert y.shape == (b, t, inner) and h.shape == (b, inner, state)
        assert y.dtype == np.float32 and h.dtype == np.float32
        for got, want in ((y, want_y), (h, want_h), (y, pal_y), (h, pal_h)):
            np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [1, 7, 65])
def test_ragged_lengths_match_the_oracle(t):
    arrays = _inputs(2, t, 40, 16, seed=t)
    want_y, want_h = (np.asarray(a) for a in jax_ref(*map(jnp.asarray, arrays)))
    y, h = _port(selective_scan, arrays)
    np.testing.assert_allclose(y, want_y, atol=TOL, rtol=0)
    np.testing.assert_allclose(h, want_h, atol=TOL, rtol=0)


def test_state_carry_composes():
    """[0:T] equals [0:T/2] then [T/2:T] from the carried state."""
    x, dt, bm, cm, a, _ = _inputs(1, 128, 64, 16, seed=9)
    h0 = np.zeros((1, 64, 16), np.float32)
    y_full, h_full = _port(selective_scan, (x, dt, bm, cm, a, h0))
    h = 61
    y1, h1 = _port(selective_scan, (x[:, :h], dt[:, :h], bm[:, :h], cm[:, :h], a, h0))
    y2, h2 = _port(selective_scan, (x[:, h:], dt[:, h:], bm[:, h:], cm[:, h:], a, h1))
    np.testing.assert_allclose(np.concatenate([y1, y2], 1), y_full, atol=TOL, rtol=0)
    np.testing.assert_allclose(h2, h_full, atol=TOL, rtol=0)
    want_y, want_h = jax_ref(*map(jnp.asarray, (x, dt, bm, cm, a, h0)))
    np.testing.assert_allclose(y_full, np.asarray(want_y), atol=TOL, rtol=0)


def test_strided_b_and_c_views():
    """B and C as the model makes them: column slices of one projection."""
    x, dt, bm, cm, a, h0 = _inputs(2, 33, 24, 8, seed=3)
    proj = torch.as_tensor(np.concatenate([np.ones((2, 33, 5), np.float32), bm, cm], -1))
    _, bv, cv = torch.split(proj, [5, 8, 8], dim=-1)
    assert not bv.is_contiguous()
    y, h = selective_scan(torch.as_tensor(x), torch.as_tensor(dt), bv, cv,
                          torch.as_tensor(a), torch.as_tensor(h0))
    want_y, want_h = jax_ref(*map(jnp.asarray, (x, dt, bm, cm, a, h0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=TOL, rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=TOL, rtol=0)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    mamba_kernel.selective_scan_cuda.launches = 0
    _port(selective_scan, _inputs(1, 5, 8, 4, seed=0))
    assert mamba_kernel.selective_scan_cuda.launches == 0


# ---------------------------------------------------------------------------
# Hymba's Mamba heads (models/ssm.py)
# ---------------------------------------------------------------------------


def _hymba(seed=0):
    cfg = jax_config("hymba-1.5b", smoke=True)
    jp = JS.init_mamba(jax.random.PRNGKey(seed), cfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, get_model_config("hymba-1.5b", smoke=True), jp, tp


def _state(cfg, b, seed):
    inner, state, _ = JS.mamba_dims(cfg)
    rng = np.random.default_rng(seed)
    h = (rng.normal(size=(b, inner, state)) * 0.1).astype(np.float32)
    conv = rng.normal(size=(b, cfg.ssm.conv_width - 1, inner)).astype(np.float32)
    return (JS.MambaState(jnp.asarray(h), jnp.asarray(conv)),
            S.MambaState(torch.as_tensor(h), torch.as_tensor(conv)))


def test_mamba_preproc_matches():
    cfg, tcfg, jp, tp = _hymba(1)
    x = np.random.default_rng(1).normal(size=(2, 19, cfg.d_model)).astype(np.float32)
    jst, tst = _state(cfg, 2, seed=1)
    want = JS._mamba_preproc(jp, jnp.asarray(x), jst.conv, cfg)
    got = S._mamba_preproc(tp, torch.as_tensor(x), tst.conv, tcfg)
    names = ("xi", "z", "dt", "B", "C", "new_buf")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("t", [64, 128, 37])
def test_mamba_scan_routes_match(t):
    """Prefill from a carried state and conv buffer: the reference's default
    route (and its Pallas route where T is a multiple of its chunk) against
    both of the port's."""
    cfg, tcfg, jp, tp = _hymba(2)
    x = np.random.default_rng(t).normal(size=(2, t, cfg.d_model)).astype(np.float32)
    jst, tst = _state(cfg, 2, seed=t)
    want, wst = JS.mamba_scan(jp, jnp.asarray(x), jst, cfg)
    refs = [(want, wst)]
    if t % 64 == 0:
        refs.append(JS.mamba_scan(jp, jnp.asarray(x), jst, cfg, impl="pallas"))
    for impl in ("xla", "cuda"):
        got, gst = S.mamba_scan(tp, torch.as_tensor(x), tst, tcfg, impl=impl)
        for w, ws in refs:
            np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=TOL, rtol=0)
            np.testing.assert_allclose(gst.h.numpy(), np.asarray(ws.h), atol=TOL, rtol=0)
            np.testing.assert_allclose(gst.conv.numpy(), np.asarray(ws.conv), atol=TOL,
                                       rtol=0)


def test_mamba_decode_steps_continue_the_prefill():
    """One-token steps after a prefill, from the reference's state."""
    cfg, tcfg, jp, tp = _hymba(3)
    x = np.random.default_rng(3).normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    jst, tst = _state(cfg, 2, seed=3)
    full, _ = JS.mamba_scan(jp, jnp.asarray(x), jst, cfg)
    _, tst = S.mamba_scan(tp, torch.as_tensor(x[:, :20]), tst, tcfg, impl="cuda")
    for i in range(20, 24):
        out, tst = S.mamba_scan(tp, torch.as_tensor(x[:, i:i + 1]), tst, tcfg)
        np.testing.assert_allclose(out.numpy()[:, 0], np.asarray(full[:, i]), atol=TOL,
                                   rtol=0)


def test_unknown_mixer_impl_is_an_error():
    cfg, tcfg, _, tp = _hymba(0)
    _, tst = _state(cfg, 1, seed=0)
    with pytest.raises(ValueError, match="unknown mixer impl"):
        S.mamba_scan(tp, torch.zeros(1, 4, cfg.d_model), tst, tcfg, impl="pallas")


def test_init_mamba_layout_and_distributions():
    cfg, tcfg, jp, _ = _hymba(0)
    gen = torch.Generator().manual_seed(0)
    got = S.init_mamba(gen, tcfg, torch.float32, lead=(3,))
    want = jax.tree.map(lambda a: ((3,) + a.shape, str(a.dtype)), jp)
    assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in got.items()} == want
    # torch's and XLA's fp32 log may differ in the last bit
    np.testing.assert_allclose(got["log_a"][1].numpy(), np.asarray(jp["log_a"]),
                               atol=1e-6, rtol=0)
    assert bool((got["dt_bias"] == np.float32(-4.6)).all())
    assert bool((got["d_skip"] == 1).all())
    assert abs(float(got["conv"].std()) - 0.1) < 0.01
    st = S.init_mamba_state(tcfg, 2, torch.device("cpu"), lead=(3,))
    jst = JS.init_mamba_state(cfg, 2)
    assert tuple(st.h.shape) == (3,) + jst.h.shape
    assert tuple(st.conv.shape) == (3,) + jst.conv.shape


# ---------------------------------------------------------------------------
# the CUDA kernel's arithmetic, emulated in numpy fp32 (csrc/mamba.cu)
# ---------------------------------------------------------------------------

KERNEL_TOL = 2e-5          # chip_smoke.py's SSM_TOL: x max(1, max |ref|) of the row


def _fma32(a, b, c):
    """fp32 fused multiply-add: the exact product and sum, rounded once (to
    fp64, then fp32; the double rounding is far below the tolerance)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _scan_fp64(x, dt, bm, cm, a, h0):
    """The plain version in fp64, on the same fp32 inputs."""
    x, dt, bm, cm, a, h = (v.astype(np.float64) for v in (x, dt, bm, cm, a, h0))
    ys = []
    for t in range(x.shape[1]):
        h = np.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * x[:, t])[..., None] * bm[:, t, None]
        ys.append(np.einsum("bis,bs->bi", h, cm[:, t]))
    return np.stack(ys, 1), h


def _scan_kernel_emulation(x, dt, bm, cm, a, h0, lanes, npt):
    """mamba.cu's order of fp32 operations with ``npt`` chains a lane on
    ``lanes`` lanes (lane l holds entries l, l + lanes, ...): one chain per
    (b, c, s), da = expf(dt A) and (dt x) B off the chain,
    h = fma(da, h, (dt x) B), the lane's p = h C over its chains in order
    (an FMA chain), and y's sum over the channel's lanes as the
    reduce-scatter's tree: lanes l and l + lanes / 2 first, then
    l + lanes / 4, ... (padded entries add 0)."""
    b, t, inner = x.shape
    state = a.shape[1]
    pad = lanes * npt - state
    bm, cm = (np.pad(m, [(0, 0), (0, 0), (0, pad)]) for m in (bm, cm))
    a = np.pad(a, [(0, 0), (0, pad)])
    h = np.pad(h0, [(0, 0), (0, 0), (0, pad)])
    ys = np.empty((b, t, inner), np.float32)
    for tt in range(t):
        d = dt[:, tt, :, None]
        da = np.exp(d * a)                                          # fp32 expf
        u = (d * x[:, tt, :, None]) * bm[:, tt, None]
        h = _fma32(da, h, u)
        p = h[..., :lanes] * cm[:, tt, None, :lanes]
        for e in range(1, npt):
            s = slice(e * lanes, (e + 1) * lanes)
            p = _fma32(h[..., s], cm[:, tt, None, s], p)
        while p.shape[-1] > 1:
            half = p.shape[-1] // 2
            p = p[..., :half] + p[..., half:]
        ys[:, tt] = p[..., 0]
    return ys, h[..., :state]


# (lanes, chains a lane) of each instantiation that takes a state width
def _splits(state):
    if state <= 4:
        return [(4, 1)]
    if state <= 8:
        return [(8, 1)]
    if state <= 16:
        return [(4, 4), (8, 2)]
    return [(32, 1)] if state <= 32 else [(32, 2)]


def _rows_within(got, want, axes):
    scale = np.maximum(1.0, np.abs(want).max(axis=axes, keepdims=True))
    err = np.abs(got.astype(np.float64) - want)
    assert np.isfinite(got).all() and (err <= KERNEL_TOL * scale).all(), float(err.max())


@pytest.mark.parametrize("model", [True, False], ids=["hymba", "reference_test"])
@pytest.mark.parametrize("state", [3, 12, 16, 20, 64])
def test_kernel_order_of_operations_meets_the_card_tolerance(state, model):
    """A numpy fp32 emulation of the kernel's order of operations (the
    decays and inputs off the chain, the one-FMA recurrence, the lanes'
    reduce-scatter tree) within the card's 2e-5 * max(1, |ref|) row
    tolerance of an fp64 evaluation of the plain version, for every lane
    split that takes the state width, on Hymba's dt and A (dt =
    softplus(N(0, 1) - 4.6), A = -(1 .. state)) and the reference test's,
    over 300 tokens."""
    x, dt, bm, cm, a, h0 = _inputs(2, 300, 8, state, seed=state, h0_scale=1.0)
    if model:
        rng = np.random.default_rng(state + 1)
        dt = np.log1p(np.exp(rng.normal(size=dt.shape) - 4.6)).astype(np.float32)
        a = -np.broadcast_to(np.arange(1, state + 1, dtype=np.float32), a.shape).copy()
    want_y, want_h = _scan_fp64(x, dt, bm, cm, a, h0)
    for lanes, npt in _splits(state):
        y, h = _scan_kernel_emulation(x, dt, bm, cm, a, h0, lanes, npt)
        _rows_within(y, want_y, (1,))
        _rows_within(h, want_h, (2,))
