"""pairwise_rank: the masked pairwise RankNet loss (forward and score
gradient in one CUDA launch, the plain PyTorch version, and the public op)."""
from repro_torch.kernels.pairwise_rank.kernel import (
    pairwise_rank_fused_cuda,
    pairwise_rank_fwd_cuda,
)
from repro_torch.kernels.pairwise_rank.ops import pairwise_rank
from repro_torch.kernels.pairwise_rank.ref import pairwise_rank_fused_ref, pairwise_rank_ref

__all__ = ["pairwise_rank", "pairwise_rank_ref", "pairwise_rank_fused_ref",
           "pairwise_rank_fused_cuda", "pairwise_rank_fwd_cuda"]
