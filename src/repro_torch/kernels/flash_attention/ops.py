"""Public flash-attention op: the prefill attention of the LM serving path.

``models/attention.py::attention_prefill(impl="flash")`` calls
:func:`flash_attention`, which calls the dispatcher op
``repro_torch::flash_attention``.  The tensors' device decides what runs: on
the card the CUDA kernel
(:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention_cuda`),
on the CPU its plain version, on meta and fake tensors the fake
implementation (the output's shape after the kernel's data-free checks), so
the dry-run counts the kernel route.  There is no fold: the reference's op
transposes q, k and v into the Pallas kernel's ``(B*KV, S*G, Dh)`` layout;
the CUDA kernel reads them where they lie.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import define_op, fresh, refuse_grad
from repro_torch.kernels.flash_attention.kernel import (
    _check,
    check_launch,
    flash_attention_cuda,
)


def _kernel(q, k, v, causal, window):
    return flash_attention_cuda(q, k, v, causal=causal, window=window)


def _plain(q, k, v, causal, window):
    return fresh(_kernel(q, k, v, causal, window), q)


def _fake(q, k, v, causal, window):
    _check(q, k, v, window)
    check_launch(q, k, v)
    return torch.empty_like(q, memory_format=torch.contiguous_format)


OP = define_op("flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
               "SymInt? window) -> Tensor", _kernel, _plain, _fake)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, Dh); k/v: (B, S, KV, Dh) -> (B, S, H, Dh).  Forward
    only: inputs that require grad raise (:func:`refuse_grad`)."""
    refuse_grad("flash_attention", q, k, v)
    return OP(q, k, v, causal, window)
