"""sgd_update: the SGD update of a stacked leaf in one pass (CUDA kernel,
plain PyTorch version, and the public op the vmapped executor calls)."""
from repro_torch.kernels.sgd_update.kernel import sgd_update_cuda
from repro_torch.kernels.sgd_update.ops import sgd_update
from repro_torch.kernels.sgd_update.ref import sgd_update_ref

__all__ = ["sgd_update_cuda", "sgd_update", "sgd_update_ref"]
