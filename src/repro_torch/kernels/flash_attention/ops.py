"""Public flash-attention op: the prefill attention of the LM serving path.

``models/attention.py::attention_prefill(impl="flash")`` calls
:func:`flash_attention`.  The tensors' device decides what runs: on the card
the CUDA kernel (:func:`~repro_torch.kernels.flash_attention.kernel.flash_attention_cuda`),
on the CPU its plain version.  There is no fold: the reference's op
transposes q, k and v into the Pallas kernel's ``(B*KV, S*G, Dh)`` layout;
the CUDA kernel reads them where they lie.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, Dh); k/v: (B, S, KV, Dh) -> (B, S, H, Dh).  Forward
    only: inputs that require grad raise (:func:`refuse_grad`)."""
    refuse_grad("flash_attention", q, k, v)
    return flash_attention_cuda(q, k, v, causal=causal, window=window)
