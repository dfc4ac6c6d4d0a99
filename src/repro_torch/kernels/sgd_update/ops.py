"""Public SGD-update op: the vmapped executor's update of one stacked leaf.

``fl/client.py::_sgd_stacked`` calls :func:`sgd_update` on every leaf of
a step, which calls the dispatcher op ``repro_torch::sgd_update``.  The
tensors' device decides what runs: on the card the CUDA kernel
(:func:`~repro_torch.kernels.sgd_update.kernel.sgd_update_cuda`), on the CPU
its plain version, on meta and fake tensors the fake implementation (a
fresh contiguous output after the kernel's data-free checks).  The update
is out of place: a may be the caller's initial params or an ``expand`` of
the global params, and the output never aliases it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import define_op, fresh
from repro_torch.kernels.sgd_update.kernel import _check, check_launch, sgd_update_cuda


def _plain(a, g, lr):
    return fresh(sgd_update_cuda(a, g, lr), a)


def _fake(a, g, lr):
    _check(a, g)
    check_launch(a, g)
    return a.new_empty(a.shape)


OP = define_op("sgd_update(Tensor a, Tensor g, float lr) -> Tensor",
               sgd_update_cuda, _plain, _fake)


def sgd_update(a: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """a, g: (K, ...) of one dtype (a may be broadcast over K) ->
    (K, ...) contiguous, ``(a.float() - lr * g.float()).to(a.dtype)``."""
    return OP(a, g, lr)
