"""Plain PyTorch version of the RWKV6 (Finch) WKV recurrence.

Per head of width n, with data-dependent decay w_t = exp(logw_t) in (0, 1]:

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

:func:`wkv6_ref` is the reference's ``repro.kernels.rwkv6.ref.wkv6_ref`` in
its ``(BH, T, n)`` layout, a loop over tokens in fp32.
:func:`wkv6_heads_ref` runs it on the model's ``(B, T, H, n)`` layout.  CPU
tensors take them in place of the kernel; on the card ``chip_smoke.py``
holds the kernel to them.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (BH, T, n); u: (BH, n); s0: (BH, n, n) ->
    (y (BH, T, n) in r's dtype, s_final (BH, n, n) fp32)."""
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    uf = u.float()
    S = s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, None] * vf[:, t, None, :]                # (BH, n, n)
        ys.append(torch.einsum("bi,bij->bj", rf[:, t], S + uf[..., :, None] * kv))
        S = wf[:, t, :, None] * S + kv
    y = torch.stack(ys, 1) if ys else rf.new_zeros(r.shape)
    return y.to(r.dtype), S


def wkv6_heads_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw: (B, T, H, n); u: (H, n) or (B, H, n); s0: (B, H, n, n)
    -> (y (B, T, H, n), s_final (B, H, n, n)): :func:`wkv6_ref` on the
    heads folded into the batch."""
    b, t, h, n = r.shape

    def fold(a):
        return a.permute(0, 2, 1, 3).reshape(b * h, t, n)

    uf = u.expand(b, h, n).reshape(b * h, n)
    y, s = wkv6_ref(fold(r), fold(k), fold(v), fold(logw), uf, s0.reshape(b * h, n, n))
    return y.reshape(b, h, t, n).permute(0, 2, 1, 3), s.reshape(b, h, n, n)
