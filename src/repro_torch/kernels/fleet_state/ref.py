"""Plain PyTorch version of the fleet state-at-time segment lookup.

"Which timeline segment is fleet device ``d`` in at time ``t``" over a
compiled trace's flat CSR segment arrays.  Times arrive split into an exact
int32 whole-second part and an f32 fraction, compared lexicographically, so
week-scale clocks never round through f32 (the reference's
``kernels/fleet_state/ref.py`` contract).  The segment index of query
``(src, qi, qf)`` is the masked count

    #{s : dev[s] < src} + #{s : dev[s] == src and (ti[s], tf[s]) <=lex (qi, qf)} - 1

computed over query chunks so no (N, S) mask is ever materialised: at most
``MAX_ELEMS`` compares per chunk.  This is what the CUDA kernel
(:mod:`repro_torch.kernels.fleet_state.kernel`) is held to, with exact
equality.
"""
from __future__ import annotations

import torch

# compares per chunk: bounds each (chunk, S) boolean temporary
MAX_ELEMS = 1 << 22


def segment_index_ref(seg_dev: torch.Tensor, seg_ti: torch.Tensor,
                      seg_tf: torch.Tensor, src: torch.Tensor,
                      qi: torch.Tensor, qf: torch.Tensor) -> torch.Tensor:
    """(N,) int32 global segment index of each query.

    ``seg_dev``/``seg_ti`` int32 and ``seg_tf`` float32 describe the flat
    segment array (device index, whole seconds, sub-second fraction of each
    segment start, CSR order); ``src``/``qi`` int32 and ``qf`` float32 are
    each query's device index and split trace time.
    """
    n, s = src.shape[0], seg_dev.shape[0]
    chunk = max(1, MAX_ELEMS // max(s, 1))
    out = torch.empty(n, dtype=torch.int32, device=src.device)
    dev, ti, tf = seg_dev[None, :], seg_ti[None, :], seg_tf[None, :]
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        d, qs, qfrac = src[lo:hi, None], qi[lo:hi, None], qf[lo:hi, None]
        le_t = (ti < qs) | ((ti == qs) & (tf <= qfrac))
        hit = (dev < d) | ((dev == d) & le_t)
        out[lo:hi] = hit.sum(dim=1, dtype=torch.int32) - 1
    return out
