"""flash_attention: prefill attention (CUDA kernel, plain PyTorch version,
and the public op the attention layer calls)."""
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention_cuda", "flash_attention", "attention_ref"]
