"""Public selective-scan op: the Mamba heads' scan over a prompt.

``models/ssm.py::mamba_scan(impl="cuda")`` calls :func:`selective_scan`.  The
tensors' device decides what runs: on the card the CUDA kernel
(:func:`~repro_torch.kernels.mamba.kernel.selective_scan_cuda`), on the CPU
its plain version.  No chunk size: the kernel takes any T >= 1 (the
reference's Pallas wrapper needs T to be a multiple of its chunk).  Nothing
is copied: B and C may be strided views (the model's split of ``x_proj``'s
output), which the kernel reads through their strides.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.mamba.kernel import selective_scan_cuda


def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/dt: (B,T,inner); Bm/Cm: (B,T,state); A: (inner,state);
    h0: (B,inner,state) -> (y (B,T,inner), h_final), all fp32.  Forward
    only: inputs that require grad raise (:func:`refuse_grad`)."""
    refuse_grad("selective_scan", x, dt, Bm, Cm, A, h0)
    return selective_scan_cuda(x, dt, Bm, Cm, A, h0)
