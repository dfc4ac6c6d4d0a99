"""Pairwise (RankNet) ranking losses — the paper's §3.4 contribution.

    P_ij    = sigma(Q_i - Q_j)               (Eq. 3, predicted)
    Pbar_ij = sigma(Qbar_i - Qbar_j)         (Eq. 3, target network / expert)
    L_Rank  = -sum_ij [ Pbar log P + (1 - Pbar) log(1 - P) ]   (Eq. 4)

Every function takes tensors with any leading batch dims.

* ``pairwise_bce`` takes *soft* target probabilities (online RL: from the
  target network); plain torch, as in the reference, which has no kernel
  for it.
* ``pairwise_bce_hard`` takes a target score vector and uses hard 1/0 (ties
  0.5) comparisons (imitation: expert utilities).  It goes through the
  ``pairwise_rank`` op: on the card its forward and gradient are CUDA
  kernels, on the CPU the plain version with autograd.
* ``ranking_accuracy`` and ``topk_overlap`` are the imitation eval metrics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pairwise_rank.ops import pairwise_rank
from repro_torch.kernels.select_topk.ref import stable_topk


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


def pairwise_bce_hard(scores: torch.Tensor, target_scores: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Hard pairwise targets from a reference score vector (expert utility):
    scores, target_scores, mask (..., M) -> mean pair BCE (...,)."""
    return pairwise_rank(scores, target_scores, mask, hard=True)


def ranking_accuracy(scores: torch.Tensor, target_scores: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Fraction of correctly-ordered (non-tied) pairs (...,) — an eval
    metric."""
    ps = _pair_logits(scores)
    pt = _pair_logits(target_scores)
    pm = _pair_mask(mask) * (pt.abs() > 1e-12)
    hit = (torch.sign(ps) == torch.sign(pt)).float()
    return ((hit * pm).sum(dim=(-2, -1))
            / torch.clamp(pm.sum(dim=(-2, -1)), min=1.0))


def topk_overlap(scores: torch.Tensor, target_scores: torch.Tensor, k: int,
                 mask: torch.Tensor) -> torch.Tensor:
    """|topK(scores) ∩ topK(target)| / K (...,) on valid entries; equal
    scores go to the lowest index, as ``lax.top_k`` does."""
    neg = -1e30 * (1.0 - mask.float())
    _, a = stable_topk(scores + neg, k)
    _, b = stable_topk(target_scores + neg, k)
    inter = (a[..., :, None] == b[..., None, :]).sum(dim=(-2, -1))
    return inter.float() / k
