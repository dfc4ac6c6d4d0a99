"""Public WKV6 op: the WKV core of RWKV6's time mix.

``models/ssm.py::rwkv_time_mix_chunked(impl="cuda")`` calls
:func:`wkv6_heads` on its projections in the model's ``(B, T, H, n)``
layout; :func:`wkv6` keeps the reference's ``(BH, T, n)`` signature.  Both
call the dispatcher op ``repro_torch::wkv6`` (the model's layout).  The
tensors' device decides what runs: on the card the CUDA kernel
(:func:`~repro_torch.kernels.rwkv6.kernel.wkv6_cuda`), on the CPU its plain
version, on meta and fake tensors the fake implementation (the outputs'
shapes after the kernel's data-free checks), so the dry-run counts the
kernel route.  No chunk size: the kernel runs the recurrence and takes any
T >= 1.  Nothing is copied: both layouts reach the kernel as views.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import define_op, fresh, refuse_grad
from repro_torch.kernels.rwkv6.kernel import _check, check_launch, wkv6_cuda


def _plain(r, k, v, logw, u, s0):
    y, s = wkv6_cuda(r, k, v, logw, u, s0)
    return fresh(y, r), fresh(s, s0)


def _fake(r, k, v, logw, u, s0):
    _check(r, k, v, logw, u, s0)
    check_launch(r, s0)
    return r.new_empty(r.shape), s0.new_empty(s0.shape)


OP = define_op("wkv6(Tensor r, Tensor k, Tensor v, Tensor logw, Tensor u, Tensor s0)"
               " -> (Tensor, Tensor)", wkv6_cuda, _plain, _fake)


def wkv6_heads(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (B, T, H, n); u: (H, n) or (B, H, n); s0: (B, H, n, n)
    -> (y (B, T, H, n), s_final (B, H, n, n)), all fp32.  Forward only:
    inputs that require grad raise (:func:`refuse_grad`)."""
    refuse_grad("wkv6_heads", r, k, v, logw, u, s0)
    return OP(r, k, v, logw, u, s0)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (BH, T, n); u: (BH, n); s0: (BH, n, n) ->
    (y (BH, T, n), s_final (BH, n, n)), all fp32.  Forward only, as
    :func:`wkv6_heads`."""
    refuse_grad("wkv6", r, k, v, logw, u, s0)
    y, s = OP(r[:, :, None], k[:, :, None], v[:, :, None], logw[:, :, None],
              u[:, None], s0[:, None])
    return y[:, :, 0], s[:, 0]
