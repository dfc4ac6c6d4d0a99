"""Kernels written by hand for Hopper, each beside its plain PyTorch version.

    select_topk    fused Q-net scoring -> top-K cohort selection (CUDA C++,
                   csrc/select_topk.cu); ops.select_topk is the port's
                   selection path
    pairwise_rank  masked pairwise RankNet loss and its score gradient in
                   one launch (CUDA C++, csrc/pairwise_rank.cu);
                   ops.pairwise_rank is the imitation-learning objective
    fleet_state    trace segment lookup, the state of every fleet device at
                   its time (CUDA C++, csrc/fleet_state.cu); ops.segment_index
                   is every trace scenario's mask and load query
    flash_attention
                   GQA prefill attention with causal and sliding-window
                   masks (CUDA C++, csrc/flash_attention.cu);
                   ops.flash_attention is the LM prefill's attention
    mamba          Mamba-1 selective scan, the state in registers (CUDA C++,
                   csrc/mamba.cu); ops.selective_scan is Hymba's Mamba heads'
                   prefill scan
    rwkv6          RWKV6 WKV recurrence with data-dependent decay (CUDA C++,
                   csrc/rwkv6.cu); ops.wkv6_heads is RWKV6's prefill WKV core

``_build`` compiles each source with ``nvcc`` at first use and binds it with
``ctypes``.

The ``flash_attention``, ``mamba`` and ``rwkv6`` kernels have no backward:
their ops refuse inputs that require grad (:func:`refuse_grad`) on every
device, so a loss taken through them raises instead of training with
missing gradients.
"""
from __future__ import annotations

import torch


def refuse_grad(op: str, *tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` when autograd is on and any of ``tensors``
    requires grad: the op ``op`` has no backward.  The check is the same on
    the CPU, where the op takes its differentiable plain version, as on the
    card, where the kernel's output would carry no gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError(
            f"{op} has no backward, and an input requires grad: train through "
            "the differentiable routes, impl='naive' or impl='blocked', or "
            "call it under torch.no_grad()")
