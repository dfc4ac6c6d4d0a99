"""Memory-efficient attention with a flash-style backward, in plain tensor
code: the reference's ``flash_attention_xla`` (its ``jax.custom_vjp``) as a
``torch.autograd.Function``.

Differentiating a chunked online softmax through autograd would save every
chunk's softmax state, O(S^2) per layer.  Here the forward saves only
``(q, k, v, out, lse)``, and the backward recomputes the probabilities chunk
by chunk from the saved log-sum-exp: the flash-attention recipe, with the
reference's schedule.  Every (q-chunk, kv-chunk) pair is visited, none is
skipped; masked scores are the finite ``NEG_INF``; dq is summed per q-chunk
over the kv-chunks in order, dk and dv across q-chunks in order.  A chunk
that does not divide S becomes S, as in the reference.

Layout: q (B, S, KV, G, Dh); k/v (B, S, KV, Dh).  fp32 accumulation; the
outputs and gradients in the inputs' dtypes.  The products are
``torch.einsum`` (matrix products, on the card cuBLAS's): the reference's
are XLA's, outside any Pallas kernel, and this route launches none of the
port's hand-written kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _chunks(s: int, q_chunk: int, kv_chunk: int) -> Tuple[int, int]:
    return (q_chunk if s % q_chunk == 0 else s), (kv_chunk if s % kv_chunk == 0 else s)


def _scores(qi, kj, qpos, kpos, causal, window, scale):
    """Masked scaled scores (b, kv, g, qc, kc), fp32."""
    sc = torch.einsum("bqkgd,bskd->bkgqs", qi, kj) * scale
    msk = _mask(qpos, kpos, causal, window)
    return torch.where(msk[None, None, None], sc, sc.new_tensor(NEG_INF))


def _fwd_impl(q, k, v, causal, window, q_chunk, kv_chunk):
    """Returns (out (B,S,KV,G,Dh) in q.dtype, lse (B,KV,G,S) fp32)."""
    b, s, kvh, g, dh = q.shape
    qc, kc = _chunks(s, q_chunk, kv_chunk)
    scale = dh ** -0.5
    dev = q.device
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for i in range(s // qc):
        qi = q[:, i * qc:(i + 1) * qc].float()
        qpos = i * qc + torch.arange(qc, device=dev)
        m_run = torch.full((b, kvh, g, qc), NEG_INF, dtype=torch.float32, device=dev)
        l_run = torch.zeros((b, kvh, g, qc), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, qc, dh), dtype=torch.float32, device=dev)
        for j in range(s // kc):
            kpos = j * kc + torch.arange(kc, device=dev)
            sc = _scores(qi, kf[:, j * kc:(j + 1) * kc], qpos, kpos, causal, window, scale)
            m_new = torch.maximum(m_run, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vf[:, j * kc:(j + 1) * kc])
            m_run = m_new
        o = acc / torch.clamp(l_run[..., None], min=1e-30)
        lses.append(m_run + torch.log(torch.clamp(l_run, min=1e-30)))
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))           # (b, qc, kv, g, dh)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def _bwd_impl(q, k, v, out, lse, dout, causal, window, q_chunk, kv_chunk):
    b, s, kvh, g, dh = q.shape
    qc, kc = _chunks(s, q_chunk, kv_chunk)
    scale = dh ** -0.5
    dev = q.device
    do = dout.float()
    # D_i = rowsum(dout * out) per query (B, KV, G, S)
    delta = torch.einsum("bskgd,bskgd->bkgs", do, out.float())
    dk = torch.zeros((b, s, kvh, dh), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, s, kvh, dh), dtype=torch.float32, device=dev)
    dqs = []
    for i in range(s // qc):
        rows = slice(i * qc, (i + 1) * qc)
        qi, doi = q[:, rows].float(), do[:, rows]
        lse_i, d_i = lse[..., rows], delta[..., rows]
        qpos = i * qc + torch.arange(qc, device=dev)
        dq_i = torch.zeros((b, qc, kvh, g, dh), dtype=torch.float32, device=dev)
        for j in range(s // kc):
            cols = slice(j * kc, (j + 1) * kc)
            kj, vj = k[:, cols].float(), v[:, cols].float()
            kpos = j * kc + torch.arange(kc, device=dev)
            sc = _scores(qi, kj, qpos, kpos, causal, window, scale)
            p = torch.exp(sc - lse_i[..., None])                     # (b, kv, g, qc, kc)
            dv[:, cols] += torch.einsum("bkgqs,bqkgd->bskd", p, doi)
            dp = torch.einsum("bqkgd,bskd->bkgqs", doi, vj)
            ds = p * (dp - d_i[..., None]) * scale
            dq_i = dq_i + torch.einsum("bkgqs,bskd->bqkgd", ds, kj)
            dk[:, cols] += torch.einsum("bkgqs,bqkgd->bskd", ds, qi)
        dqs.append(dq_i)
    return torch.cat(dqs, dim=1).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashXLA(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, causal, window, q_chunk, kv_chunk):
        return _fwd_impl(q, k, v, causal, window, q_chunk, kv_chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, q_chunk, kv_chunk = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.static = (causal, window, q_chunk, kv_chunk)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_impl(q, k, v, out, lse, dout, *ctx.static)
        return dq, dk, dv, None, None, None, None


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        q_chunk: int = 512, kv_chunk: int = 1024) -> torch.Tensor:
    """q (B, S, KV, G, Dh), k/v (B, S, KV, Dh) -> out (B, S, KV, G, Dh) in
    q's dtype; differentiable in q, k and v (the backward recomputes the
    probabilities from the saved log-sum-exp)."""
    return _FlashXLA.apply(q, k, v, causal, window, q_chunk, kv_chunk)[0]
