"""Plain PyTorch version of the Mamba-1 selective scan.

    h_t = exp(dt_t ⊙ A) h_{t-1} + (dt_t * x_t) B_t
    y_t = C_t . h_t

The reference's ``repro.kernels.mamba.ref.selective_scan_ref`` (and the
per-token ``"xla"`` route of its ``models/ssm.py::mamba_scan``): a loop over
tokens in fp32.  x/dt: (B, T, inner); Bm/Cm: (B, T, state); A: (inner,
state); h0: (B, inner, state).  CPU tensors take it in place of the kernel;
on the card ``chip_smoke.py`` holds the kernel to it.
"""
from __future__ import annotations

from typing import Tuple

import torch


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                       Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, T, inner) in x's dtype, h_T (B, inner, state) fp32)."""
    xf, dtf, Bf, Cf, Af = (a.float() for a in (x, dt, Bm, Cm, A))
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dtf[:, t, :, None] * Af)                 # (B, inner, state)
        h = da * h + (dtf[:, t] * xf[:, t])[..., None] * Bf[:, t, None, :]
        ys.append(torch.einsum("bis,bs->bi", h, Cf[:, t]))
    y = torch.stack(ys, 1) if ys else xf.new_zeros(x.shape)
    return y.to(x.dtype), h
