"""Public op: the masked pairwise RankNet loss with its gradient.

``pairwise_rank(scores, targets, mask, hard=False)`` takes (..., N) tensors
and returns the per-cohort mean pair BCE (...,).  The tensors' device
decides, as for ``select_topk``:

* CUDA tensors that need a gradient go through a
  ``torch.autograd.Function`` whose forward makes one launch for the loss
  and the gradient together and saves the gradient; its backward scales it
  by the upstream gradient and launches no pair kernel.  Without a gradient
  (``torch.no_grad()``, or scores that do not require one) one launch
  computes the loss alone (:mod:`repro_torch.kernels.pairwise_rank.kernel`);
* CPU tensors take the plain version and autograd.

Gradients flow to ``scores`` only, as in the reference's custom VJP
(``src/repro/kernels/pairwise_rank/ops.py``): targets and mask are data.
``hard=True`` is the imitation objective (1 / 0 / 0.5 pair targets from the
sign of ``t_i - t_j``); ``hard=False`` uses ``sigmoid(t_i - t_j)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pairwise_rank.kernel import (
    pairwise_rank_fused_cuda,
    pairwise_rank_fwd_cuda,
)
from repro_torch.kernels.pairwise_rank.ref import pairwise_rank_ref


class _PairwiseRankCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, targets, mask, hard):
        loss, _, grad = pairwise_rank_fused_cuda(scores, targets, mask, hard=hard)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        (grad,) = ctx.saved_tensors
        return grad_loss[:, None] * grad, None, None, None


def _loss_on_card(s: torch.Tensor, t: torch.Tensor, m: torch.Tensor,
                  hard: bool) -> torch.Tensor:
    """(B, N) rows -> (B,) losses: the fused launch when autograd will want
    the scores' gradient, the loss-only launch otherwise."""
    if torch.is_grad_enabled() and s.requires_grad:
        return _PairwiseRankCuda.apply(s, t, m, hard)
    loss, _ = pairwise_rank_fwd_cuda(s, t, m, hard=hard)
    return loss


def pairwise_rank(scores: torch.Tensor, targets: torch.Tensor,
                  mask: torch.Tensor, hard: bool = False) -> torch.Tensor:
    """scores, targets, mask (..., N) -> mean pair BCE (...,) over valid
    i != j pairs of each cohort."""
    lead, n = scores.shape[:-1], scores.shape[-1]

    def rows(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(-1, n).float().contiguous()

    s, t, m = rows(scores), rows(targets.detach()), rows(mask.detach())
    if scores.device.type == "cpu":
        loss = pairwise_rank_ref(s, t, m, hard)
    else:
        loss = _loss_on_card(s, t, m, bool(hard))
    return loss.reshape(lead)
