"""Public WKV6 op: the WKV core of RWKV6's time mix.

``models/ssm.py::rwkv_time_mix_chunked(impl="cuda")`` calls
:func:`wkv6_heads` on its projections in the model's ``(B, T, H, n)``
layout; :func:`wkv6` keeps the reference's ``(BH, T, n)`` signature.  The
tensors' device decides what runs: on the card the CUDA kernel
(:func:`~repro_torch.kernels.rwkv6.kernel.wkv6_cuda`), on the CPU its plain
version.  No chunk size: the kernel runs the recurrence and takes any
T >= 1.  Nothing is copied: both layouts reach the kernel as views.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.rwkv6.kernel import wkv6_cuda


def wkv6_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (B, T, H, n); u: (H, n) or (B, H, n); s0: (B, H, n, n)
    -> (y (B, T, H, n), s_final (B, H, n, n)), all fp32.  Forward only:
    inputs that require grad raise (:func:`refuse_grad`)."""
    refuse_grad("wkv6_heads", r, k, v, logw, u, s0)
    return wkv6_cuda(r, k, v, logw, u, s0)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (BH, T, n); u: (BH, n); s0: (BH, n, n) ->
    (y (BH, T, n), s_final (BH, n, n)), all fp32.  Forward only, as
    :func:`wkv6_heads`."""
    refuse_grad("wkv6", r, k, v, logw, u, s0)
    y, s = wkv6_cuda(r[:, :, None], k[:, :, None], v[:, :, None], logw[:, :, None],
                     u[:, None], s0[:, None])
    return y[:, :, 0], s[:, 0]
