"""CUDA kernel for Hopper: the RWKV6 WKV recurrence (forward).

Replaces the TPU kernel ``src/repro/kernels/rwkv6/kernel.py:74``
(``wkv6_pallas``), which runs the chunked matrix form on the MXU.  That
form scales keys by ``exp(-cum)`` and overflows fp32 once the log-decay
summed over a chunk is large; the source here,
``src/repro_torch/csrc/rwkv6.cu``, runs the recurrence, which computes the
same function and stays finite for any decay: one CTA per (batch, head),
thread j owning column j of the (n, n) state in registers, 32-token chunks
of r, k, exp(logw) and v staged in shared memory.  It reads r, k, v and logw
in the model's ``(B, T, H, n)`` layout through their strides.  Its header
gives the bound on the card.

``LIBRARY`` builds the source with ``nvcc`` at first use into
``build/kernels/`` (:mod:`repro_torch.kernels._build`).  Nothing is built
when this module is imported.

:func:`wkv6_cuda` launches the kernel for CUDA tensors and takes the plain
version (:func:`~repro_torch.kernels.rwkv6.ref.wkv6_heads_ref`) only for
CPU tensors; any other device raises.  ``wkv6_cuda.launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.rwkv6.ref import wkv6_heads_ref

MAX_N = 64                # rwkv6.cu: one thread per state column, <= 64
MAX_CTAS = 2**31 - 1


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.wkv6_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 19 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("rwkv6", _bind)


def _check(r, k, v, logw, u, s0) -> None:
    named = (("r", r), ("k", k), ("v", v), ("logw", logw), ("u", u), ("s0", s0))
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"wkv6 takes float32 tensors; {name} is {t.dtype}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, n), got {tuple(r.shape)}")
    b, t, h, n = r.shape
    for name, tensor in (("k", k), ("v", v), ("logw", logw)):
        if tensor.shape != r.shape:
            raise ValueError(f"{name} has shape {tuple(tensor.shape)}, r {tuple(r.shape)}")
    if tuple(u.shape) not in ((h, n), (b, h, n)):
        raise ValueError(f"u has shape {tuple(u.shape)}, expected {(h, n)} or {(b, h, n)}")
    if tuple(s0.shape) != (b, h, n, n):
        raise ValueError(f"s0 has shape {tuple(s0.shape)}, expected {(b, h, n, n)}")


def wkv6_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, s0: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/logw (B, T, H, n), u (H, n) or (B, H, n), s0 (B, H, n, n), all
    float32 -> (y (B, T, H, n), s_T (B, H, n, n)).

    CUDA tensors launch the kernel (and count the launch); CPU tensors take
    the plain version; anything else raises.  r, k, v, logw and u are read
    through their strides (any layout); s0 must be contiguous.  The kernel
    takes n <= 64 and raises on anything else rather than copy.
    """
    _check(r, k, v, logw, u, s0)
    dev = r.device
    if dev.type == "cpu":
        return wkv6_heads_ref(r, k, v, logw, u, s0)
    if dev.type != "cuda":
        raise ValueError(f"wkv6 runs on cuda or cpu tensors, got {dev}")
    b, t, h, n = r.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"wkv6 kernel takes 1 <= n <= {MAX_N}, got {n}")
    if b * h > MAX_CTAS:
        raise ValueError(f"wkv6 kernel takes B * H <= {MAX_CTAS}")
    if not s0.is_contiguous():
        raise ValueError("wkv6 kernel needs s0 contiguous")
    ub = u.expand(b, h, n)
    y = torch.empty((b, t, h, n), dtype=torch.float32, device=dev)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    if t == 0 or b * h == 0:
        s_fin.copy_(s0)
        return y, s_fin
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.wkv6_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), ub.data_ptr(),
            s0.data_ptr(), y.data_ptr(), s_fin.data_ptr(), b, t, h, n,
            *r.stride(), *k.stride(), *v.stride(), *logw.stride(), *ub.stride(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6_cuda.launches += 1
    return y, s_fin


wkv6_cuda.launches = 0
