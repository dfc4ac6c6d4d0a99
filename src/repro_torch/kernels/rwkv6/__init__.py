"""rwkv6: the RWKV6 WKV recurrence (CUDA kernel, plain PyTorch version, and
the public op RWKV6's time mix calls)."""
from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
from repro_torch.kernels.rwkv6.ops import wkv6, wkv6_heads
from repro_torch.kernels.rwkv6.ref import wkv6_heads_ref, wkv6_ref

__all__ = ["wkv6_cuda", "wkv6", "wkv6_heads", "wkv6_ref", "wkv6_heads_ref"]
