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
    arrays = _inputs(1, 9, 4, 2, 32, seed=0)
    _port(flash_attention, arrays, causal=True)
    assert fa_kernel.flash_attention_cuda.launches == 0


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
    q = torch.zeros(1, 4, 2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q, q, q, causal=True)
