"""CUDA kernel for Hopper: the RWKV6 WKV recurrence (forward).

Replaces the TPU kernel ``src/repro/kernels/rwkv6/kernel.py:74``
(``wkv6_pallas``), which runs the chunked matrix form on the MXU.  That
form scales keys by ``exp(-cum)`` and overflows fp32 once the log-decay
summed over a chunk is large; the source here,
``src/repro_torch/csrc/rwkv6.cu``, runs the recurrence, which computes the
same function and stays finite for any decay.  A head's (n, n) state is
split into 4 x 4 register tiles (4 x 2 with fewer heads than SMs) over
many threads and, at n > 32, its columns over 2 CTAs; 16-token chunks of
r, k, logw and v are staged with ``cp.async`` (16-byte copies where the
rows are 16-byte aligned, which the C entry checks), the next chunk in
flight while the current one is consumed.  It reads r, k, v and logw in
the model's ``(B, T, H, n)`` layout through their strides.  Its header
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

from repro_torch.kernels._build import CudaLibrary, call_on_device, stream_handle
from repro_torch.kernels.rwkv6.ref import wkv6_heads_ref

MAX_N = 64                # rwkv6.cu: a head's rows in 16 row groups of 4
MAX_HEADS = (2**31 - 1) // 2   # B * H, times a column split of up to 2 CTAs


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.wkv6_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 19 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.wkv6_occupancy
    occ.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int


LIBRARY = CudaLibrary("rwkv6", _bind)


_NAMES = ("r", "k", "v", "logw", "u", "s0")


def _check(r, k, v, logw, u, s0) -> None:
    dev = r.device
    for name, t in zip(_NAMES, (r, k, v, logw, u, s0)):
        if t.dtype is not torch.float32:
            raise ValueError(f"wkv6 takes float32 tensors; {name} is {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, r on {dev}")
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


def check_launch(r: torch.Tensor, s0: torch.Tensor) -> None:
    """What the kernel refuses that shapes and strides show, without data:
    n outside 1..64, B * H past the grid, s0 not contiguous.  The op's fake
    implementation runs it too, so a dry-run refuses what the card would."""
    b, _, h, n = r.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"wkv6 kernel takes 1 <= n <= {MAX_N}, got {n}")
    if b * h > MAX_HEADS:
        raise ValueError(f"wkv6 kernel takes B * H <= {MAX_HEADS}")
    if not s0.is_contiguous():
        raise ValueError("wkv6 kernel needs s0 contiguous")


def launch_config(n: int, heads: int) -> dict:
    """The kernel's launch configuration for width ``n`` and ``heads`` =
    B * H, from the built library (card only): the row capacity, the column
    split, the columns of a thread's tile, threads per CTA, the resident
    CTAs per SM that ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``
    reports, static shared memory per CTA and registers per thread."""
    out = (ctypes.c_int * 7)()
    err = LIBRARY.load().wkv6_occupancy(n, heads, out)
    if err != 0:
        raise RuntimeError(f"wkv6_occupancy failed: CUDA error {err}")
    keys = ("nmax", "col_split", "tile_cols", "threads", "ctas_per_sm", "smem_bytes",
            "registers")
    return dict(zip(keys, out))


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
    check_launch(r, s0)
    b, t, h, n = r.shape
    u_strides = u.stride() if u.dim() == 3 else (0, *u.stride())   # u shared by the batch
    y = torch.empty((b, t, h, n), dtype=torch.float32, device=dev)
    s_fin = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    if t == 0 or b * h == 0:
        s_fin.copy_(s0)
        return y, s_fin
    lib = LIBRARY.load()
    err = call_on_device(
        dev.index, lib.wkv6_launch,
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        s0.data_ptr(), y.data_ptr(), s_fin.data_ptr(), b, t, h, n,
        *r.stride(), *k.stride(), *v.stride(), *logw.stride(), *u_strides,
        stream_handle(dev.index))
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6_cuda.launches += 1
    return y, s_fin


wkv6_cuda.launches = 0
