"""Plain PyTorch version of flash attention (GQA, causal, sliding window).

The reference's ``repro.kernels.flash_attention.ref.attention_ref``: the
whole (S, S) score matrix per head in fp32, masked with the finite
``NEG_INF = -1e30``, softmax, product with v; the output in ``q``'s dtype.
CPU tensors take it in place of the kernel; on the card ``chip_smoke.py``
holds the kernel to it.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None
                  ) -> torch.Tensor:
    """q: (B, S, H, Dh); k/v: (B, S, KV, Dh) -> (B, S, H, Dh) (fp32 math)."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, dh).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * dh ** -0.5
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.tensor(NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v.float())
    return out.reshape(b, s, h, dh).to(q.dtype)
