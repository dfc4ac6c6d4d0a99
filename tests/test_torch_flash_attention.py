"""flash_attention in the port against the JAX reference, on the CPU.

The port's op (what CPU tensors take: the plain version; the CUDA kernel is
held to the plain version on the card by ``chip_smoke.py``) and its plain
version against ``repro``'s jnp oracle ``attention_ref`` and against its op
``flash_attention``, which runs the Pallas kernel in interpret mode.  The
Pallas wrapper needs S * G to divide into its 128-row blocks, so those cases
keep S * G <= 256 (and interpret mode fast); ragged sequence lengths, which
the CUDA kernel takes and the Pallas wrapper refuses, are held to the oracle
alone.

Tolerance: 1e-5 on fp32 inputs (fp32 sums in another order); on bf16 inputs
one bf16 rounding of the output, 2^-8 of its magnitude (both sides compute
in fp32 and round once).

The tensor-core kernel (bf16, Dh <= 128) runs only on the card, where
``chip_smoke.py`` holds it to the plain version at ``2^-7 |ref| + 2e-5`` per
element.  Its arithmetic is emulated here in fp32: 64-key tiles, the online
softmax in base 2 with the finite ``NEG_INF``, and P split into a bf16 high
and a bf16 low part whose products with v are summed in fp32.  The emulation
stays within that tolerance of the reference; the same emulation with P
rounded once to bf16 (FlashAttention-2's choice) does not, which is why the
kernel splits P.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = 1e-5


def _inputs(b, s, h, kv, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, dh)).astype(np.float32) for n in (h, kv, kv)]


def _port(fn, arrays, **kw):
    return fn(*(torch.as_tensor(a) for a in arrays), **kw).numpy()


# (b, s, h, kv, dh, causal, window): S*G <= 256 and S*G a multiple of 128
# or at most 128, as the Pallas wrapper's blocks need
PALLAS_CASES = [
    (1, 32, 8, 1, 128, True, None),      # Yi-6B's G=8, Dh=128
    (2, 32, 8, 1, 128, False, None),
    (1, 32, 8, 2, 64, True, 8),
    (1, 16, 5, 1, 64, True, 4),          # Hymba's G=5
    (1, 16, 5, 1, 64, False, None),
    (1, 64, 4, 2, 120, True, 16),        # h2o-danube's Dh=120
    (1, 128, 2, 2, 64, True, 48),        # G=1: window across the 128-key block
    (2, 128, 1, 1, 32, False, 32),
]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_matches_reference_and_pallas(case):
    b, s, h, kv, dh, causal, window = case
    arrays = _inputs(b, s, h, kv, dh, seed=s + h + dh)
    want = np.asarray(jax_ref(*map(jnp.asarray, arrays), causal=causal, window=window))
    pallas = np.asarray(jax_flash(*map(jnp.asarray, arrays), causal=causal,
                                  window=window))
    np.testing.assert_allclose(pallas, want, atol=TOL, rtol=0)
    for fn in (flash_attention, attention_ref):
        got = _port(fn, arrays, causal=causal, window=window)
        assert got.shape == (b, s, h, dh) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
        np.testing.assert_allclose(got, pallas, atol=TOL, rtol=0)


@pytest.mark.parametrize("case", [
    (1, 1, 8, 1, 128, True, None),
    (2, 7, 4, 4, 64, True, None),
    (1, 129, 10, 2, 120, True, 64),
    (1, 129, 10, 2, 120, False, 64),
    (1, 100, 25, 5, 64, True, 1),        # window 1: each query sees itself
    (1, 33, 16, 16, 256, False, None),   # gemma-7b's Dh=256
], ids=lambda c: "-".join(map(str, c)))
def test_ragged_lengths_match_reference(case):
    b, s, h, kv, dh, causal, window = case
    arrays = _inputs(b, s, h, kv, dh, seed=s * 7 + dh)
    want = np.asarray(jax_ref(*map(jnp.asarray, arrays), causal=causal, window=window))
    got = _port(flash_attention, arrays, causal=causal, window=window)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_bf16_inputs_match_reference():
    arrays = _inputs(2, 48, 8, 2, 64, seed=3)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    want = np.asarray(jax_ref(jq, jk, jv, causal=True, window=20)).astype(np.float32)
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in arrays)
    got = flash_attention(tq, tk, tv, causal=True, window=20)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=2.0 ** -8 * max(1.0, np.abs(want).max()),
                               rtol=0)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    fa_kernel.flash_attention_cuda.launches = 0
    fa_kernel.flash_attention_cuda.mma_launches = 0
    arrays = _inputs(1, 9, 4, 2, 32, seed=0)
    _port(flash_attention, arrays, causal=True)
    tq, tk, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in arrays)
    flash_attention(tq, tk, tv, causal=True)
    assert fa_kernel.flash_attention_cuda.launches == 0
    assert fa_kernel.flash_attention_cuda.mma_launches == 0


@pytest.mark.parametrize("bad,match", [
    (dict(window=0), "window"),
    (dict(kv_heads=3), "groups"),
    (dict(k_len=8), "do not match"),
    (dict(v_dtype=torch.float64), "dtype"),
])
def test_wrapper_refuses_malformed_inputs(bad, match):
    q = torch.zeros(1, 9, 4, 32)
    k = torch.zeros(1, bad.get("k_len", 9), bad.get("kv_heads", 2), 32)
    v = k.to(bad.get("v_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        flash_attention(q, k, v, causal=True, window=bad.get("window"))


def test_other_devices_are_refused():
    """The CUDA wrapper takes cuda and cpu tensors only.  The op
    (``repro_torch::flash_attention``) takes meta tensors too, through its
    fake implementation: the output's shape, nothing computed."""
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa_kernel.flash_attention_cuda(q, q, q, causal=True)
    out = flash_attention(q, q, q, causal=True)
    assert out.device.type == "meta" and out.shape == q.shape


@pytest.mark.parametrize("dtype,dh,route", [
    (torch.bfloat16, 64, "mma"),        # Hymba
    (torch.bfloat16, 120, "mma"),       # h2o-danube, padded to 128
    (torch.bfloat16, 128, "mma"),       # Yi-6B, minitron
    (torch.bfloat16, 8, "mma"),
    (torch.bfloat16, 136, "fma"),
    (torch.bfloat16, 256, "fma"),       # gemma-7b
    (torch.float32, 64, "fma"),
    (torch.float32, 128, "fma"),
    (torch.float32, 256, "fma"),
])
def test_route_rule(dtype, dh, route):
    assert fa_kernel.flash_route(dtype, dh) == route


# ---------------------------------------------------------------------------
# the tensor-core kernel's arithmetic, emulated in fp32
# ---------------------------------------------------------------------------

BF16_ULP = 2.0 ** -7          # chip_smoke.py FA_ULP_BF16
BF16_ABS = 2e-5               # chip_smoke.py FA_TOL32
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_mma_kernel(q, k, v, *, causal, window, split_p, bk=64):
    """flash_fwd_mma_kernel's arithmetic on fp32 tensors holding bf16 values:
    per 64-key tile the fp32 scores (scaled by Dh^-0.5 log2 e), the finite
    NEG_INF mask, the running max and sum in base 2, and O += P V with P
    either split (bf16(P) + bf16(P - bf16(P))) or rounded once; the output
    acc / max(l, 1e-30) rounded to bf16."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, dh)
    scale = torch.tensor(dh ** -0.5, dtype=torch.float32) * LOG2E
    m = torch.full(qg.shape[:-1], NEG_INF)
    l = torch.zeros(qg.shape[:-1])
    acc = torch.zeros(qg.shape)
    qpos = torch.arange(s)[:, None]
    for k0 in range(0, s, bk):
        kt, vt = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
        sc = torch.einsum("bqkgd,bskd->bqkgs", qg, kt) * scale
        kpos = torch.arange(k0, min(k0 + bk, s))[None, :]
        ok = torch.ones(s, kpos.shape[1], dtype=torch.bool)
        if causal:
            ok &= kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        sc = torch.where(ok[None, :, None, None, :], sc, torch.tensor(NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1))
        corr = torch.exp2(m - m_new)
        p = torch.exp2(sc - m_new[..., None])
        l = l * corr + p.sum(-1)
        if split_p:
            hi = _bf16(p)
            pv = (torch.einsum("bqkgs,bskd->bqkgd", hi, vt)
                  + torch.einsum("bqkgs,bskd->bqkgd", _bf16(p - hi), vt))
        else:
            pv = torch.einsum("bqkgs,bskd->bqkgd", _bf16(p), vt)
        acc = acc * corr[..., None] + pv
        m = m_new
    return _bf16(acc / torch.clamp(l, min=1e-30)[..., None]).reshape(b, s, h, dh)


def _bf16_case(b, s, h, kv, dh, causal, window, seed):
    arrays = [_bf16(torch.as_tensor(a)) for a in _inputs(b, s, h, kv, dh, seed)]
    want = np.asarray(jax_ref(*(jnp.asarray(a.numpy()) for a in arrays),
                              causal=causal, window=window))
    return arrays, torch.from_numpy(want.copy())


def _tolerance_share(got, want):
    """Each element's error as a share of the card's bf16 tolerance."""
    return (got - want).abs() / (BF16_ULP * want.abs() + BF16_ABS)


# S <= 256, G in {1, 5, 8}, Dh in {64, 120}, causal and windowed
EMULATION_CASES = [
    (2, 256, 8, 1, 64, True, None),
    (1, 256, 8, 1, 120, True, 100),
    (1, 200, 5, 1, 64, True, 17),
    (1, 129, 5, 1, 120, False, None),
    (2, 130, 4, 4, 120, True, None),     # G=1
    (1, 256, 1, 1, 64, False, 64),
]


@pytest.mark.parametrize("case", EMULATION_CASES, ids=lambda c: "-".join(map(str, c)))
def test_mma_kernel_arithmetic_within_the_card_tolerance(case):
    b, s, h, kv, dh, causal, window = case
    (q, k, v), want = _bf16_case(b, s, h, kv, dh, causal, window, seed=s + dh + h)
    got = _emulate_mma_kernel(q, k, v, causal=causal, window=window, split_p=True)
    # the error is the output's own bf16 rounding, half a bf16 ulp (half the
    # tolerance), plus fp32 sums
    assert float(_tolerance_share(got, want).max()) <= 0.51


@pytest.mark.parametrize("case", EMULATION_CASES, ids=lambda c: "-".join(map(str, c)))
def test_p_rounded_once_to_bf16_breaks_the_card_tolerance(case):
    b, s, h, kv, dh, causal, window = case
    (q, k, v), want = _bf16_case(b, s, h, kv, dh, causal, window, seed=s + dh + h)
    got = _emulate_mma_kernel(q, k, v, causal=causal, window=window, split_p=False)
    share = _tolerance_share(got, want)
    assert int((share > 1.0).sum()) > 0 and float(share.max()) > 10.0
