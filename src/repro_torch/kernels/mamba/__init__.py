"""mamba: the Mamba-1 selective scan (CUDA kernel, plain PyTorch version,
and the public op Hymba's Mamba heads call)."""
from repro_torch.kernels.mamba.kernel import selective_scan_cuda
from repro_torch.kernels.mamba.ops import selective_scan
from repro_torch.kernels.mamba.ref import selective_scan_ref

__all__ = ["selective_scan_cuda", "selective_scan", "selective_scan_ref"]
