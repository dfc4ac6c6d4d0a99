"""Pairwise (RankNet) ranking losses — the paper's §3.4 contribution.

    P_ij    = sigma(Q_i - Q_j)               (Eq. 3, predicted)
    Pbar_ij = sigma(Qbar_i - Qbar_j)         (Eq. 3, target network)
    L_Rank  = -sum_ij [ Pbar log P + (1 - Pbar) log(1 - P) ]   (Eq. 4)

Plain torch on tensors with any leading batch dims; the reference has no
kernel for these.  The hard-target loss used by imitation pretraining comes
with its kernel in the next slice.
"""
from __future__ import annotations

import torch


def _pair_logits(scores: torch.Tensor) -> torch.Tensor:
    """(..., M) -> (..., M, M) matrix of score_i - score_j."""
    return scores[..., :, None] - scores[..., None, :]


def _pair_mask(mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    pm = m[..., :, None] * m[..., None, :]
    eye = torch.eye(m.shape[-1], dtype=pm.dtype, device=pm.device)
    return pm * (1.0 - eye)


def pairwise_bce(scores: torch.Tensor, target_probs: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """scores (..., M), target_probs (..., M, M) in [0, 1], mask (..., M) ->
    mean pair BCE (...,) over valid i != j pairs."""
    logits = _pair_logits(scores)
    pm = _pair_mask(mask)
    # numerically-stable BCE with logits
    bce = (torch.clamp(logits, min=0.0) - logits * target_probs
           + torch.log1p(torch.exp(-logits.abs())))
    return ((bce * pm).sum(dim=(-2, -1))
            / torch.clamp(pm.sum(dim=(-2, -1)), min=1.0))


def pairwise_soft_targets(target_scores: torch.Tensor) -> torch.Tensor:
    """Pbar_ij = sigma(Qbar_i - Qbar_j) (Eq. 3, target network side)."""
    return torch.sigmoid(_pair_logits(target_scores))
