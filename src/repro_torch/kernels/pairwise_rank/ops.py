"""Public op: the masked pairwise RankNet loss with its gradient.

``pairwise_rank(scores, targets, mask, hard=False)`` takes (..., N) tensors
and returns the per-cohort mean pair BCE (...,).  The tensors' device
decides, as for ``select_topk``:

* CUDA tensors go through a ``torch.autograd.Function`` whose forward
  launches the forward kernel and whose backward launches the gradient
  kernel (:mod:`repro_torch.kernels.pairwise_rank.kernel`);
* CPU tensors take the plain version and autograd.

Gradients flow to ``scores`` only, as in the reference's custom VJP
(``src/repro/kernels/pairwise_rank/ops.py``): targets and mask are data.
``hard=True`` is the imitation objective (1 / 0 / 0.5 pair targets from the
sign of ``t_i - t_j``); ``hard=False`` uses ``sigmoid(t_i - t_j)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pairwise_rank.kernel import (
    pairwise_rank_bwd_cuda,
    pairwise_rank_fwd_cuda,
)
from repro_torch.kernels.pairwise_rank.ref import pairwise_rank_ref


class _PairwiseRankCuda(torch.autograd.Function):
    @staticmethod
    def forward(ctx, scores, targets, mask, hard):
        loss, count = pairwise_rank_fwd_cuda(scores, targets, mask, hard=hard)
        ctx.save_for_backward(scores, targets, mask, count)
        ctx.hard = hard
        return loss

    @staticmethod
    def backward(ctx, grad_loss):
        scores, targets, mask, count = ctx.saved_tensors
        grad = pairwise_rank_bwd_cuda(scores, targets, mask, count,
                                      grad_loss.float().contiguous(),
                                      hard=ctx.hard)
        return grad, None, None, None


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
        loss = _PairwiseRankCuda.apply(s, t, m, bool(hard))
    return loss.reshape(lead)
