"""The layers the FL tasks and the Q-net use, in PyTorch.

Parameters are plain dicts of tensors in the reference's layout (``w`` shaped
``(in, out)``).  Initializers draw from an explicit ``torch.Generator`` on the
CPU and then move the tensor, so one seed gives the same weights on every
device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device: torch.device) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun): N(0, 1) cut at +-2, times
    1/sqrt(d_in) — the reference's ``dense_init`` distribution."""
    w = torch.empty((d_in, d_out), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / math.sqrt(d_in)).to(device)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over valid positions. logits (..., V), labels (...);
    fp32 statistics."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    nll = logz - gold
    m = (torch.ones_like(nll) if mask is None else mask.float())
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
