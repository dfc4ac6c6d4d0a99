"""select_topk: fused Q-net scoring -> top-K selection (CUDA kernel, plain
PyTorch version, and the public op)."""
from repro_torch.kernels.select_topk.kernel import select_topk_cuda
from repro_torch.kernels.select_topk.ops import masked_topk, select_topk, topk_indices
from repro_torch.kernels.select_topk.ref import NEG_INF, select_topk_ref

__all__ = ["select_topk_cuda", "select_topk", "masked_topk", "topk_indices",
           "NEG_INF", "select_topk_ref"]
