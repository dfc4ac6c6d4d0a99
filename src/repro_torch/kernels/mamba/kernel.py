"""CUDA kernel for Hopper: the Mamba-1 selective scan (forward).

Replaces the TPU kernel ``src/repro/kernels/mamba/kernel.py:68``
(``selective_scan_pallas``), which keeps an (inner block, state) slice of
the state in VMEM and walks T chunks on a sequential grid axis.  The source
is ``src/repro_torch/csrc/mamba.cu``: the loop over T runs inside the CTA,
with the state in registers.  A CTA takes 32 channels of one sequence;
each channel's ``state`` entries are split over a few lanes (4 entries a
lane, so 4 lanes at Hymba's state of 16) and ``y_t`` is their shuffle sum.
Each 32-token chunk of x, dt, B and C is staged in shared memory (B and C
rows are shared by every channel of the CTA) and each chunk of y leaves
from it.  Its header gives the bound on the card.

``LIBRARY`` builds the source with ``nvcc`` at first use into
``build/kernels/`` (:mod:`repro_torch.kernels._build`).  Nothing is built
when this module is imported.

:func:`selective_scan_cuda` launches the kernel for CUDA tensors and takes
the plain version (:func:`~repro_torch.kernels.mamba.ref.selective_scan_ref`)
only for CPU tensors; any other device raises.
``selective_scan_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.mamba.ref import selective_scan_ref

MAX_STATE = 64            # mamba.cu: 16 lanes x 4 entries
MAX_GRID_Y = 65535


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.selective_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("mamba", _bind)


def _check(x, dt, Bm, Cm, A, h0) -> None:
    named = (("x", x), ("dt", dt), ("Bm", Bm), ("Cm", Cm), ("A", A), ("h0", h0))
    for name, t in named:
        if t.dtype != torch.float32:
            raise ValueError(f"selective_scan takes float32 tensors; {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, inner), got {tuple(x.shape)}")
    b, t, inner = x.shape
    state = A.shape[-1] if A.dim() == 2 else -1
    for name, tensor, shape in (("dt", dt, (b, t, inner)), ("Bm", Bm, (b, t, state)),
                                ("Cm", Cm, (b, t, state)), ("A", A, (inner, state)),
                                ("h0", h0, (b, inner, state))):
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensor.shape)}, expected {shape}")


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/dt (B, T, inner), Bm/Cm (B, T, state), A (inner, state), h0 (B,
    inner, state), all float32 -> (y (B, T, inner), h_T (B, inner, state)).

    CUDA tensors launch the kernel (and count the launch); CPU tensors take
    the plain version; anything else raises.  x, dt, Bm and Cm are read
    through their strides (any layout; the last dimension contiguous is the
    fast case); A and h0 must be contiguous.  The kernel takes state <= 64
    and B <= 65535 and raises on anything else rather than copy.
    """
    _check(x, dt, Bm, Cm, A, h0)
    dev = x.device
    if dev.type == "cpu":
        return selective_scan_ref(x, dt, Bm, Cm, A, h0)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu tensors, got {dev}")
    b, t, inner = x.shape
    state = A.shape[1]
    if not 1 <= state <= MAX_STATE:
        raise ValueError(f"selective_scan kernel takes 1 <= state <= {MAX_STATE}, got {state}")
    if b > MAX_GRID_Y:
        raise ValueError(f"selective_scan kernel takes B <= {MAX_GRID_Y}, got {b}")
    for name, tensor in (("A", A), ("h0", h0)):
        if not tensor.is_contiguous():
            raise ValueError(f"selective_scan kernel needs {name} contiguous")
    y = torch.empty((b, t, inner), dtype=torch.float32, device=dev)
    h_fin = torch.empty((b, inner, state), dtype=torch.float32, device=dev)
    if t == 0 or b == 0 or inner == 0:
        h_fin.copy_(h0)
        return y, h_fin
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.selective_scan_launch(
            x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_fin.data_ptr(), b, t, inner, state,
            *x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    selective_scan_cuda.launches += 1
    return y, h_fin


selective_scan_cuda.launches = 0
