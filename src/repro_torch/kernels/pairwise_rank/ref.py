"""Plain PyTorch version of the pairwise RankNet loss over masked cohorts.

Loss (paper Eq. 3-4) over all ordered pairs i != j of valid entries of each
batch row:

    P_ij    = sigma(s_i - s_j)
    Pbar_ij = sigma(t_i - t_j)           (soft), or 1 / 0 / 0.5 by the sign
                                         of t_i - t_j (hard: imitation)
    L       = sum_ij pm_ij BCE(P_ij ; Pbar_ij) / max(sum_ij pm_ij, 1)

with ``pm_ij = m_i m_j`` and the diagonal knocked out.  This is the
semantics the CUDA kernels (:mod:`repro_torch.kernels.pairwise_rank.kernel`)
are held to; its autograd gradient is what the gradient kernels are held to.
:func:`pairwise_rank_fused_ref` is the fused launch's function in plain
form: loss, count and the gradient as the row reduction the kernels compute.
It materialises (B, N, N) matrices.  It computes in float32, or in float64
when the scores are float64 (the exact reference a card check can compare
an fp32 kernel with).
"""
from __future__ import annotations

from typing import Tuple

import torch


def pair_targets(targets: torch.Tensor, hard: bool) -> torch.Tensor:
    """(B, N) -> (B, N, N) target pair probabilities."""
    d = targets[..., :, None] - targets[..., None, :]
    if hard:
        return torch.where(d > 0, 1.0, torch.where(d < 0, 0.0, 0.5))
    return torch.sigmoid(d)


def pairwise_rank_sums(scores: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor, hard: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores, targets, mask (B, N) -> (sum of pm * BCE (B,), count (B,))."""
    dt = torch.float64 if scores.dtype == torch.float64 else torch.float32
    s, t, m = scores.to(dt), targets.to(dt), mask.to(dt)
    logits = s[..., :, None] - s[..., None, :]
    tgt = pair_targets(t, hard)
    eye = torch.eye(s.shape[-1], dtype=dt, device=s.device)
    pm = m[..., :, None] * m[..., None, :] * (1.0 - eye)
    bce = (torch.clamp(logits, min=0.0) - logits * tgt
           + torch.log1p(torch.exp(-logits.abs())))
    return (bce * pm).sum(dim=(-2, -1)), pm.sum(dim=(-2, -1))


def pairwise_rank_ref(scores: torch.Tensor, targets: torch.Tensor,
                      mask: torch.Tensor, hard: bool = False) -> torch.Tensor:
    """scores, targets, mask (B, N) -> mean pair BCE per row (B,), fp32
    (fp64 for fp64 scores)."""
    total, count = pairwise_rank_sums(scores, targets, mask, hard)
    return total / torch.clamp(count, min=1.0)


def pairwise_rank_fused_ref(scores: torch.Tensor, targets: torch.Tensor,
                            mask: torch.Tensor, hard: bool = False
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """scores, targets, mask (B, N) -> (loss (B,), count (B,) float64, grad
    (B, N)): the mean pair BCE, the pair count and the gradient of each
    row's loss with respect to its scores, ``2 / max(count, 1) * sum_j
    pm_ij (sigmoid(s_i - s_j) - tgt_ij)`` (fp32, fp64 for fp64 scores)."""
    dt = torch.float64 if scores.dtype == torch.float64 else torch.float32
    s, t, m = scores.detach().to(dt), targets.to(dt), mask.to(dt)
    total, count = pairwise_rank_sums(s, t, m, hard)
    denom = torch.clamp(count, min=1.0)
    eye = torch.eye(s.shape[-1], dtype=dt, device=s.device)
    pm = m[..., :, None] * m[..., None, :] * (1.0 - eye)
    terms = torch.sigmoid(s[..., :, None] - s[..., None, :]) - pair_targets(t, hard)
    grad = 2.0 / denom[..., None] * (pm * terms).sum(-1)
    return total / denom, count.double(), grad
