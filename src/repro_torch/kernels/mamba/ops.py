"""Public selective-scan op: the Mamba heads' scan over a prompt.

``models/ssm.py::mamba_scan(impl="cuda")`` calls :func:`selective_scan`,
which calls the dispatcher op ``repro_torch::selective_scan``.  The tensors'
device decides what runs: on the card the CUDA kernel
(:func:`~repro_torch.kernels.mamba.kernel.selective_scan_cuda`), on the CPU
its plain version, on meta and fake tensors the fake implementation (the
outputs' shapes after the kernel's data-free checks), so the dry-run counts
the kernel route.  No chunk size: the kernel takes any T >= 1 (the
reference's Pallas wrapper needs T to be a multiple of its chunk).  Nothing
is copied: B and C may be strided views (the model's split of ``x_proj``'s
output), which the kernel reads through their strides.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import define_op, fresh, refuse_grad
from repro_torch.kernels.mamba.kernel import _check, check_launch, selective_scan_cuda


def _plain(x, dt, Bm, Cm, A, h0):
    y, h = selective_scan_cuda(x, dt, Bm, Cm, A, h0)
    return fresh(y, x), fresh(h, h0)


def _fake(x, dt, Bm, Cm, A, h0):
    _check(x, dt, Bm, Cm, A, h0)
    check_launch(x, A, h0)
    return x.new_empty(x.shape), h0.new_empty(h0.shape)


OP = define_op("selective_scan(Tensor x, Tensor dt, Tensor Bm, Tensor Cm, Tensor A, "
               "Tensor h0) -> (Tensor, Tensor)", selective_scan_cuda, _plain, _fake)


def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/dt: (B,T,inner); Bm/Cm: (B,T,state); A: (inner,state);
    h0: (B,inner,state) -> (y (B,T,inner), h_final), all fp32.  Forward
    only: inputs that require grad raise (:func:`refuse_grad`)."""
    refuse_grad("selective_scan", x, dt, Bm, Cm, A, h0)
    return OP(x, dt, Bm, Cm, A, h0)
