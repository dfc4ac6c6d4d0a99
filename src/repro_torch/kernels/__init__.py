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
    sgd_update     the SGD update of a stacked parameter leaf in one pass
                   (CUDA C++, csrc/sgd_update.cu); ops.sgd_update is the
                   vmapped FL executor's update

``_build`` compiles each source with ``nvcc`` at first use and binds it with
``ctypes``.

The three model kernels and the update are dispatcher ops in the
``repro_torch`` namespace (:func:`define_op`): ``repro_torch::flash_attention``,
``repro_torch::selective_scan``, ``repro_torch::wkv6`` and
``repro_torch::sgd_update``.  Each has a CUDA
implementation (the launch), a CPU one (the plain version) and a fake one
(the outputs' shapes, after the launch's data-free checks), so meta and fake
tensors, ``torch.profiler`` and a dispatch mode all see one op by one name;
``work`` gives each op's work from its shapes.

The ``flash_attention``, ``mamba`` and ``rwkv6`` kernels have no backward:
their ops refuse inputs that require grad (:func:`refuse_grad`) on every
device, so a loss taken through them raises instead of training with
missing gradients.
"""
from __future__ import annotations

from typing import Callable

import torch

_LIB = torch.library.Library("repro_torch", "FRAGMENT")


def define_op(schema: str, cuda: Callable, cpu: Callable, fake: Callable
              ) -> torch._ops.OpOverload:
    """Define ``repro_torch::<schema>`` with ``cuda`` for CUDA tensors,
    ``cpu`` for CPU ones and ``fake`` for meta and fake ones; returns the
    op's default overload (the cheapest handle to call).  No autograd
    formula: the public functions refuse inputs that require grad before
    the call."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    return getattr(torch.ops.repro_torch, name).default


def fresh(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``out`` contiguous and in storage of its own: an op's output may
    neither alias an input (the plain versions hand back the initial state
    itself at T = 0) nor differ in layout from what its fake implementation
    gives (the plain WKV's output is a permuted view).  The same values."""
    if out.untyped_storage().data_ptr() == like.untyped_storage().data_ptr():
        return out.clone(memory_format=torch.contiguous_format)
    return out.contiguous()


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
