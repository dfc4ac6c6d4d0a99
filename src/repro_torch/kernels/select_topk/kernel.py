"""CUDA kernel for Hopper: fused Q-net scoring -> top-K cohort selection.

Replaces the TPU kernel ``src/repro/kernels/select_topk/kernel.py``
(``select_topk_pallas``).  The source is ``src/repro_torch/csrc/select_topk.cu``;
its header comment gives the bound on the card (fp32 FMAs: 2·N·(F·H + H² + H)
FLOPs against (F + 2)·4·N bytes) and the two-pass design: one CTA per
256-row tile scores its rows and bitonic-sorts them in shared memory, then a
fixed-order tree of pairwise merges keeps the best K_pad.  Any feature width
F, hidden width H and k <= N: up to H = 128 (and weights that fit in shared
memory) the weights sit in shared memory, wider nets read them through the
read-only cache with the first layer's activations in a scratch, in the
same FMA order.  The result is exact and deterministic.

``LIBRARY`` (:class:`~repro_torch.kernels._build.CudaLibrary`) compiles the
source with ``nvcc`` at first use into ``build/kernels/`` at the repository
root (named by a hash of the source and flags, so an edited source rebuilds)
and binds it with ``ctypes``.  Nothing is built when this module is
imported.

:func:`select_topk_cuda` launches the kernel for CUDA tensors and takes the
plain version (:func:`~repro_torch.kernels.select_topk.ref.select_topk_ref`)
only for CPU tensors; any other device raises.  ``select_topk_cuda.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.select_topk.ref import select_topk_ref

TILE = 256            # candidates per CTA in pass 1 (select_topk.cu TILE)


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.select_topk_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 6)
    fn.restype = ctypes.c_int
    lib.select_topk_list_entries.argtypes = [ctypes.c_int] * 2
    lib.select_topk_list_entries.restype = ctypes.c_longlong
    lib.select_topk_h1_floats.argtypes = [ctypes.c_int] * 3
    lib.select_topk_h1_floats.restype = ctypes.c_longlong


LIBRARY = CudaLibrary("select_topk", _bind)


def k_padded(k: int) -> int:
    return max(8, -(-int(k) // 8) * 8)


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, feats on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def select_topk_cuda(params: Dict[str, torch.Tensor], feats: torch.Tensor,
                     mask: torch.Tensor, bias: torch.Tensor, *, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats (N, F), mask (N,), bias (N,) float32 -> (values (k,) float32,
    indices (k,) int64), score descending, lowest-index ties, masked rows
    last.  Requires 1 <= k <= N; any F and H.

    CUDA tensors launch the kernel (and count the launch); CPU tensors take
    the plain version; anything else raises.
    """
    if feats.device.type == "cpu":
        return select_topk_ref(params, feats, mask, bias, k=k)
    if feats.device.type != "cuda":
        raise ValueError(f"select_topk runs on cuda or cpu tensors, got "
                         f"{feats.device}")
    if feats.dim() != 2:
        raise ValueError(f"feats must be (N, F), got shape {tuple(feats.shape)}")
    n, f = feats.shape
    h = int(params["w1"].shape[1]) if params["w1"].dim() == 2 else -1
    if f < 1 or h < 1:
        raise ValueError(f"select_topk kernel takes F, H >= 1, got F={f}, H={h}")
    if not 1 <= k <= n:
        raise ValueError(f"select_topk kernel takes 1 <= k <= N, got k={k}, N={n}")
    if n > 2**31 - 1 - TILE:
        raise ValueError(f"select_topk kernel takes N < 2**31 - {TILE}, got {n}")
    dev = feats.device
    _check("feats", feats, (n, f), dev)
    _check("mask", mask, (n,), dev)
    _check("bias", bias, (n,), dev)
    for name, shape in (("w1", (f, h)), ("b1", (h,)), ("w2", (h, h)),
                        ("b2", (h,)), ("w3", (h, 1)), ("b3", (1,))):
        _check(name, params[name], shape, dev)

    lib = LIBRARY.load()
    k_pad = k_padded(k)
    n_scratch = 2 * lib.select_topk_list_entries(n, k_pad)
    scratch_v = torch.empty(n_scratch, dtype=torch.float32, device=dev)
    scratch_i = torch.empty(n_scratch, dtype=torch.int32, device=dev)
    n_h1 = lib.select_topk_h1_floats(n, f, h)
    h1 = torch.empty(n_h1, dtype=torch.float32, device=dev) if n_h1 else None
    out_v = torch.empty(k_pad, dtype=torch.float32, device=dev)
    out_i = torch.empty(k_pad, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.select_topk_launch(
            feats.data_ptr(), mask.data_ptr(), bias.data_ptr(),
            params["w1"].data_ptr(), params["b1"].data_ptr(),
            params["w2"].data_ptr(), params["b2"].data_ptr(),
            params["w3"].data_ptr(), params["b3"].data_ptr(),
            n, f, h, k_pad, scratch_v.data_ptr(), scratch_i.data_ptr(),
            h1.data_ptr() if h1 is not None else None,
            out_v.data_ptr(), out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"select_topk kernel launch failed: CUDA error {err}")
    select_topk_cuda.launches += 1
    return out_v[:k], out_i[:k].long()


select_topk_cuda.launches = 0
