"""Attention layers: GQA, causal / bidirectional / cross, sliding-window,
memory-efficient blocked attention, and single-token KV-cache decode.

Implementations of the prefill attention (``attention_prefill(impl=)``):

* ``naive`` — materializes the full (S, S) score matrix; oracle + smoke tests.
* ``flash`` — the flash-attention op of ``repro_torch.kernels.flash_attention``:
              the hand-written CUDA kernel on the card, its plain version on
              the CPU.  The reference calls this route ``pallas`` (its TPU
              kernel).
* ``blocked`` — the reference's flash attention with its chunked backward
              (``models/flash_xla.py``): plain tensor code, differentiable,
              bounded memory; the default route of ``make_train_step``.

``flash`` is forward only: its op refuses inputs that require grad, so a
loss is differentiated through ``naive`` or ``blocked``.

:func:`blocked_attention` (online softmax over query and key chunks) is the
reference's bounded-memory attention, ported as plain tensor code.  Decode
stays plain tensor code, as the reference leaves it to XLA.

Unlike the reference, whose arrays are immutable, :func:`attention_decode`
writes the new token's K/V into the cache tensors in place and returns a
cache that shares them.

Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 section 2.1 and
the ``modeling_deepseek.py`` published with its config; a port-only
architecture, :mod:`repro_torch.configs.deepseek_v2_lite`),
:func:`mla_prefill`, with ``x`` the normed input:

* ``q = x Wq``, split per head into ``q_nope`` (``qk_nope_head_dim``) and
  ``q_pe`` (``qk_rope_head_dim``); there is no low-rank query;
* ``[c_kv, k_pe] = x Wkv_a`` (widths ``kv_lora_rank`` and
  ``qk_rope_head_dim``), ``c_kv = RMSNorm(c_kv)`` (an fp32 scale, eps 1e-6);
* ``[k_nope, v] = c_kv Wkv_b`` per head (``qk_nope_head_dim``,
  ``v_head_dim``);
* ``q_pe`` and the one ``k_pe`` take YaRN RoPE; ``k_pe`` is shared by
  every head;
* ``score = [q_nope, q_pe].[k_nope, k_pe] x qk_head_dim^-0.5 x m^2`` with
  ``m = 0.1 mscale_all_dim ln(factor) + 1``; causal softmax in fp32;
  ``out = p v``, then ``out Wo`` over ``heads x v_head_dim``.

YaRN's frequencies over the ``qk_rope_head_dim`` RoPE dimensions
(:func:`yarn_freqs`): ``inv = inter (1 - mask) + extra mask`` with
``extra = theta^(-2i/dim)``, ``inter = extra / factor`` and ``mask = 1 -
ramp(low, high)`` over the correction range of ``beta_fast`` and
``beta_slow`` at the original context; the cos/sin scale
``mscale(factor, mscale) / mscale(factor, mscale_all_dim)`` is 1 for the
published settings and is applied as computed.

Departures: the q.k product is summed as ``q_nope.k_nope + q_pe.k_pe``
(the same terms, no per-head copy of ``k_pe``), and the rotated ``q_pe``
and ``k_pe`` enter it in fp32 (the products' inputs are fp32 throughout).
Layout note: the published checkpoint stores each RoPE slice's columns
interleaved and its code de-interleaves them before rotating halves; with
random weights that is a fixed permutation of the columns, so the port
rotates its half-split layout, as
:func:`repro_torch.models.layers.apply_rope` does.  MLA runs on the
``naive`` route only (the route ``LMTask`` trains through); prefill and
decode, which would need a latent KV cache, refuse it.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch._functorch.pyfunctorch import temporarily_clear_interpreter_stack
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.flash_xla import flash_attention_xla
from repro_torch.models.layers import apply_norm, apply_rope, dense_init_on, init_norm
from repro_torch.models.sharding import (
    as_dtensor,
    local_map_heads,
    local_offset,
    replicate,
    reshape,
    shard,
    whole_heads,
)
from repro_torch.obs.profiling import span

NEG_INF = -1e30
IMPLS = ("naive", "flash", "blocked")


class KVCache(NamedTuple):
    """Ring-buffer KV cache. ``k``/``v``: (B, C, KV, Dh); ``length``: (B,)
    per-sequence count of tokens ever written (positions wrap modulo C for
    SWA). Per-sequence lengths let a continuous-batching server admit
    requests into slots at different times."""

    k: torch.Tensor
    v: torch.Tensor
    length: torch.Tensor  # (B,) int32


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                   lead: Tuple[int, ...] = (), *, cross: bool = False
                   ) -> Dict[str, torch.Tensor]:
    """``wq``/``wk``/``wv``/``wo``; ``cross`` (whisper's cross-attention)
    has the same leaves, as in the reference."""
    d = cfg.d_model
    return {
        "wq": dense_init_on(gen, d, cfg.q_dim, dtype, lead),
        "wk": dense_init_on(gen, d, cfg.kv_dim, dtype, lead),
        "wv": dense_init_on(gen, d, cfg.kv_dim, dtype, lead),
        "wo": dense_init_on(gen, cfg.q_dim, d, dtype, lead),
    }


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    b, s, _ = x.shape
    # a projection sharded over more ranks than it has heads (hymba's 25, a
    # KV projection's few) is gathered first: DTensor splits no head
    return reshape(whole_heads(x, n), b, s, n, dh)


# ---------------------------------------------------------------------------
# Core score/softmax/combine — naive
# ---------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,Sq,H,Dh), k: (B,Sk,KV,Dh) -> scores (B,KV,G,Sq,Sk) fp32."""
    b, sq, h, dh = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, sq, kv, h // kv, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float())
    return s * (dh ** -0.5)


def naive_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int] = None,
    q_offset: int = 0,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-matrix attention. q (B,Sq,H,Dh), k/v (B,Sk,KV,Dh) -> (B,Sq,H,Dh).

    ``q_offset``: absolute position of q[0] (for decode/chunked use).
    ``kv_valid``: optional (B, Sk) bool mask of valid cache slots.
    """
    b, sq, h, dh = q.shape
    sk = k.shape[1]
    dev = q.device
    scores = _gqa_scores(q, k)  # (B,KV,G,Sq,Sk)
    qpos = q_offset + torch.arange(sq, device=dev)
    kpos = torch.arange(sk, device=dev)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    mask5 = mask[None, None, None]
    if kv_valid is not None:
        mask5 = mask5 & kv_valid[:, None, None, None, :]
    scores = torch.where(mask5, scores, torch.tensor(NEG_INF, device=dev))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Blocked (memory-efficient) attention
# ---------------------------------------------------------------------------


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int] = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over query chunks (the reference's
    ``blocked_attention``; a Python loop in place of ``lax.scan``).

    For sliding-window attention each query chunk only reads the
    ``window + q_chunk`` keys that can be in range, so the work scales
    O(S * window) instead of O(S^2).
    """
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    dev = q.device
    if s % q_chunk:
        q_chunk = s  # degenerate small case
    qg = q.reshape(b, s, kvh, g, dh)
    neg = torch.tensor(NEG_INF, device=dev)
    chunks = []

    if window is not None:
        # SWA: bounded KV view per query chunk (left-padded, as the reference)
        span = min(window + q_chunk, s)
        pad = span
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
        for qs in range(0, s, q_chunk):
            qc = qg[:, qs:qs + q_chunk]
            start = qs + q_chunk - span + pad
            kc, vc = kp[:, start:start + span], vp[:, start:start + span]
            qpos = qs + torch.arange(q_chunk, device=dev)
            kpos = qs + q_chunk - span + torch.arange(span, device=dev)
            mask = ((kpos[None, :] <= qpos[:, None])
                    & (kpos[None, :] > qpos[:, None] - window) & (kpos[None, :] >= 0))
            sc = torch.einsum("bqkgd,bskd->bkgqs", qc.float(), kc.float()) * (dh ** -0.5)
            pr = torch.softmax(torch.where(mask[None, None, None], sc, neg), dim=-1)
            chunks.append(torch.einsum("bkgqs,bskd->bqkgd", pr, vc.float()).to(q.dtype))
        return torch.cat(chunks, dim=1).reshape(b, s, h, dh)

    # Full (causal or bidirectional): online softmax over KV chunks.
    if s % kv_chunk:
        kv_chunk = s
    for qs in range(0, s, q_chunk):
        qc = qg[:, qs:qs + q_chunk].float()
        qpos = qs + torch.arange(q_chunk, device=dev)
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, dh), device=dev)
        for ks in range(0, s, kv_chunk):
            kc = k[:, ks:ks + kv_chunk].float()
            vc = v[:, ks:ks + kv_chunk].float()
            sc = torch.einsum("bqkgd,bskd->bkgqs", qc, kc) * (dh ** -0.5)
            if causal:
                kpos = ks + torch.arange(kv_chunk, device=dev)
                msk = kpos[None, :] <= qpos[:, None]
                sc = torch.where(msk[None, None, None], sc, neg)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p, vc)
            m = m_new
        oc = acc / torch.clamp(l[..., None], min=1e-30)       # (b,kv,g,qc,dh)
        chunks.append(oc.permute(0, 3, 1, 2, 4).to(q.dtype))  # (b,qc,kv,g,dh)
    return torch.cat(chunks, dim=1).reshape(b, s, h, dh)


# ---------------------------------------------------------------------------
# Layer-level apply
# ---------------------------------------------------------------------------


def attention_prefill(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    positions: Optional[torch.Tensor] = None,
    impl: str = "naive",
    kv_from: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Returns (output (B,S,d), (k, v)) — k/v returned for cache priming.

    ``kv_from``: encoder output for cross-attention (whisper decoder), which
    takes the naive route whatever ``impl`` says, as in the reference.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have {IMPLS}")
    b, s, _ = x.shape
    src = x if kv_from is None else kv_from
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    k = _split_heads(src @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(src @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "kv_heads", None)
    v = shard(v, "batch", "seq", "kv_heads", None)
    if cfg.use_rope and kv_from is None:
        pos = positions if positions is not None else torch.arange(s, device=x.device)[None, :]
        pos = torch.broadcast_to(pos, (b, s))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if impl == "blocked" and kv_from is None:
        def core(q, k, v):
            qg = q.reshape(q.shape[:2] + (k.shape[2], q.shape[2] // k.shape[2], q.shape[3]))
            return flash_attention_xla(qg, k, v, causal, window).reshape(q.shape)
    elif impl == "flash" and kv_from is None:
        def core(q, k, v):
            return flash_attention(q, k, v, causal=causal, window=window)
    else:
        def core(q, k, v):
            return naive_attention(q, k, v, causal=causal and kv_from is None, window=window)
    # on a mesh the core runs on each rank's batch rows and heads
    out = shard(local_map_heads(core, q, k, v), "batch", "seq", "heads", None)
    y = reshape(out, b, s, cfg.q_dim) @ p["wo"]
    return shard(y, "batch", "seq", "embed"), (k, v)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                  device: torch.device) -> KVCache:
    """``max_len`` should be the window size for SWA layers."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def attention_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cache: KVCache,
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One-token decode. x: (B, 1, d). Cache is a ring buffer of capacity C
    (== window for SWA, == max context for full attention).  The new K/V are
    written into ``cache.k``/``cache.v`` in place; the returned cache shares
    those tensors and carries ``length + 1``."""
    b = x.shape[0]
    dev = x.device
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.head_dim)
    q = shard(q, "batch", None, "heads", None)

    if cross_kv is not None:
        k, v = cross_kv
        out = local_map_heads(functools.partial(naive_attention, causal=False), q, k, v)
        return shard(reshape(out, b, 1, cfg.q_dim) @ p["wo"], "batch", None, "embed"), cache

    pos = cache.length.long()  # (B,) absolute position of each sequence's new token
    if cfg.use_rope:
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
    k_new = _split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.head_dim)
    v_new = _split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.head_dim)
    if cfg.use_rope:
        k_new = apply_rope(k_new, pos[:, None], cfg.rope_theta)
    cap = cache.k.shape[1]
    slot = torch.remainder(pos, cap)                             # (B,)
    _ring_write(cache.k, slot, k_new[:, 0])
    _ring_write(cache.v, slot, v_new[:, 0])
    k = shard(cache.k, "batch", "cache", "kv_heads", None)
    v = shard(cache.v, "batch", "cache", "kv_heads", None)

    # absolute position of each cache slot (ring semantics), per sequence
    idx = torch.arange(cap, device=dev)[None, :]                 # (1, cap)
    slot_b = slot[:, None]
    n_written = (pos + 1)[:, None]
    wrapped = n_written > cap
    abs_pos = torch.where(
        idx <= slot_b, n_written - 1 - (slot_b - idx),
        torch.where(wrapped, n_written - 1 - (slot_b + cap - idx),
                    torch.full_like(idx, -1)))
    kv_valid = abs_pos >= 0
    if window is not None:
        kv_valid &= abs_pos > pos[:, None] - window

    # a sequence-sharded cache: the whole (small) query meets each shard of
    # it, and the softmax gathers the scores
    out = naive_attention(replicate(q, dims=(2,)), k, v, causal=False, kv_valid=kv_valid)
    y = reshape(out, b, 1, cfg.q_dim) @ p["wo"]
    return shard(y, "batch", None, "embed"), KVCache(cache.k, cache.v, cache.length + 1)


def _ring_write(buf: torch.Tensor, slot: torch.Tensor, new: torch.Tensor) -> None:
    """``buf[b, slot[b]] = new[b]`` for every sequence b, in place.  On a
    DTensor cache each rank writes the rows and slots its shard holds."""
    if not isinstance(buf, DTensor):
        buf[torch.arange(buf.shape[0], device=buf.device), slot] = new.to(buf.dtype)
        return
    mesh = buf.device_mesh
    want = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
            for p in buf.placements]
    new_l = new.redistribute(mesh, want).to_local().to(buf.dtype)
    slot_l = as_dtensor(slot, mesh).redistribute(
        mesh, [Shard(0) if p == Shard(0) else Replicate() for p in buf.placements]).to_local()
    local = buf.to_local()
    c0 = local_offset(buf, 1)
    ls = slot_l.long() - c0
    hit = (ls >= 0) & (ls < local.shape[1])
    lsc = ls.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, lsc] = torch.where(hit[:, None, None], new_l, local[rows, lsc])


# ---------------------------------------------------------------------------
# Multi-head latent attention (MLA)
# ---------------------------------------------------------------------------


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """``wq`` (d, H (nope + rope)), ``wkv_a`` (d, rank + rope), the latent
    norm ``kv_norm`` (fp32 scale of ``rank``), ``wkv_b`` (rank, H (nope +
    v)) and ``wo`` (H v, d); every leaf with ``lead`` stacked axes first."""
    d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {
        "wq": dense_init_on(gen, d, h * (nope + rope), dtype, lead),
        "wkv_a": dense_init_on(gen, d, r + rope, dtype, lead),
        "kv_norm": init_norm("rmsnorm", r, torch.float32, gen.device, lead),
        "wkv_b": dense_init_on(gen, r, h * (nope + vd), dtype, lead),
        "wo": dense_init_on(gen, h * vd, d, dtype, lead),
    }


def _yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_freqs(cfg: ModelConfig, device=None) -> Tuple[torch.Tensor, float]:
    """(inverse frequencies (rope/2,) fp32, the cos/sin scale) of YaRN over
    ``cfg.qk_rope_head_dim`` dimensions, as the published code computes
    them."""
    dim, base, factor = cfg.qk_rope_head_dim, cfg.rope_theta, cfg.rope_factor
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (factor * base ** exps)

    def corr(rot: float) -> float:
        return (dim * math.log(cfg.rope_original_max_pos / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(cfg.rope_beta_fast)), 0)
    high = min(math.ceil(corr(cfg.rope_beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    inv = inter * (1 - mask) + extra * mask
    scale = (_yarn_mscale(factor, cfg.rope_mscale)
             / _yarn_mscale(factor, cfg.rope_mscale_all_dim))
    return inv, scale


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """``qk_head_dim^-0.5 x m^2``, ``m`` YaRN's temperature of
    ``mscale_all_dim`` (1 without it)."""
    m = _yarn_mscale(cfg.rope_factor, cfg.rope_mscale_all_dim) if cfg.rope_mscale_all_dim else 1.0
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


@functools.lru_cache(maxsize=16)
def _mla_tables(cfg: ModelConfig, s: int, device: torch.device):
    """(cos, sin) (S, 1, rope/2) fp32 of YaRN at positions 0..S-1, times
    its cos/sin scale, and the (S, S) causal mask: the same for every call
    at one length, so made once, outside any ``torch.func`` transform (a
    tensor made inside one would be that transform's, and leak from it)."""
    with temporarily_clear_interpreter_stack():
        inv, scale = yarn_freqs(cfg, device)
        ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv
        pos = torch.arange(s, device=device)
        return ((torch.cos(ang) * scale)[:, None, :], (torch.sin(ang) * scale)[:, None, :],
                pos[None, :] <= pos[:, None])


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of x (..., S, H, D) in fp32."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def mla_prefill(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig, *,
                impl: str = "naive") -> torch.Tensor:
    """MLA over a full causal sequence (the module docstring's equations):
    x (B, S, d) -> (B, S, d), on the ``naive`` route only.  Opens the span
    ``mla``."""
    if impl != "naive":
        raise ValueError(f"{cfg.name}: multi-head latent attention runs on the naive "
                         f"route only, not {impl!r}")
    with span("mla"):
        b, s, _ = x.shape
        h, r = cfg.n_heads, cfg.kv_lora_rank
        nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        cos, sin, causal = _mla_tables(cfg, s, x.device)
        q = (x @ p["wq"]).reshape(b, s, h, nope + rope)
        kv_a = x @ p["wkv_a"]
        c_kv = apply_norm("rmsnorm", p["kv_norm"], kv_a[..., :r])
        kv = (c_kv @ p["wkv_b"]).reshape(b, s, h, nope + vd)
        q_pe = _rotate(q[..., nope:], cos, sin)
        k_pe = _rotate(kv_a[..., None, r:], cos, sin)[:, :, 0]        # (B, S, rope), every head's
        scores = (torch.einsum("bqhd,bkhd->bhqk", q[..., :nope].float(), kv[..., :nope].float())
                  + torch.einsum("bqhd,bkd->bhqk", q_pe, k_pe))
        scores = (scores * mla_softmax_scale(cfg)).masked_fill(~causal, NEG_INF)
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, kv[..., nope:].float()).to(x.dtype)
        return out.reshape(b, s, h * vd) @ p["wo"]
