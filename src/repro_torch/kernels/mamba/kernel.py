"""CUDA kernel for Hopper: the Mamba-1 selective scan (forward).

Replaces the TPU kernel ``src/repro/kernels/mamba/kernel.py:68``
(``selective_scan_pallas``), which keeps an (inner block, state) slice of
the state in VMEM and walks T chunks on a sequential grid axis.  The source
is ``src/repro_torch/csrc/mamba.cu``: the loop over T runs inside the CTA,
with the state in registers, one (b, c, s) chain a lane (at Hymba's state
of 16: four chains a lane on 4 lanes where the grid has a CTA for every SM,
else two on 8 lanes).  For each 16-token chunk the decays and inputs of all its tokens
come first, off the serial chain, then the one-FMA-a-token recurrence, then
``y_t``'s sum over the entries as a reduce-scatter over the channel's
lanes.  The chunks of x, dt, B and C are staged with ``cp.async`` (4-byte
copies that transpose them entry-major, through their strides), the next
two in flight while one is worked.  Its header gives the bound on the
card.

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

from repro_torch.kernels._build import CudaLibrary, call_on_device, stream_handle
from repro_torch.kernels.mamba.ref import selective_scan_ref

MAX_STATE = 64            # mamba.cu: 32 lanes x 2 entries
MAX_GRID_Y = 65535


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.selective_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.selective_scan_occupancy
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    occ.restype = ctypes.c_int


def launch_config(state: int, batch: int, inner: int) -> dict:
    """The kernel's launch configuration for ``state`` entries, ``batch``
    sequences and ``inner`` channels, from the built library (card only):
    lanes per channel, entries per lane, threads per CTA, the resident CTAs
    per SM that ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports,
    static shared memory per CTA and registers per thread."""
    out = (ctypes.c_int * 6)()
    err = LIBRARY.load().selective_scan_occupancy(state, batch, inner, out)
    if err != 0:
        raise RuntimeError(f"selective_scan_occupancy failed: CUDA error {err}")
    keys = ("lanes", "entries_per_lane", "threads", "ctas_per_sm", "smem_bytes",
            "registers")
    return dict(zip(keys, out))


LIBRARY = CudaLibrary("mamba", _bind)


_NAMES = ("x", "dt", "Bm", "Cm", "A", "h0")


def _check(x, dt, Bm, Cm, A, h0) -> None:
    dev = x.device
    for name, t in zip(_NAMES, (x, dt, Bm, Cm, A, h0)):
        if t.dtype is not torch.float32:
            raise ValueError(f"selective_scan takes float32 tensors; {name} is {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if x.dim() != 3:
        raise ValueError(f"x must be (B, T, inner), got {tuple(x.shape)}")
    b, t, inner = x.shape
    state = A.shape[-1] if A.dim() == 2 else -1
    for name, tensor, shape in (("dt", dt, (b, t, inner)), ("Bm", Bm, (b, t, state)),
                                ("Cm", Cm, (b, t, state)), ("A", A, (inner, state)),
                                ("h0", h0, (b, inner, state))):
        if tuple(tensor.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(tensor.shape)}, expected {shape}")


def check_launch(x: torch.Tensor, A: torch.Tensor, h0: torch.Tensor) -> None:
    """What the kernel refuses that shapes and strides show, without data:
    state outside 1..64, B > 65535, A or h0 not contiguous.  The op's fake
    implementation runs it too, so a dry-run refuses what the card would."""
    state = A.shape[1]
    if not 1 <= state <= MAX_STATE:
        raise ValueError(f"selective_scan kernel takes 1 <= state <= {MAX_STATE}, got {state}")
    if x.shape[0] > MAX_GRID_Y:
        raise ValueError(f"selective_scan kernel takes B <= {MAX_GRID_Y}, got {x.shape[0]}")
    for name, tensor in (("A", A), ("h0", h0)):
        if not tensor.is_contiguous():
            raise ValueError(f"selective_scan kernel needs {name} contiguous")


def selective_scan_cuda(x: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
                        Cm: torch.Tensor, A: torch.Tensor, h0: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x/dt (B, T, inner), Bm/Cm (B, T, state), A (inner, state), h0 (B,
    inner, state), all float32 -> (y (B, T, inner), h_T (B, inner, state)).

    CUDA tensors launch the kernel (and count the launch); CPU tensors take
    the plain version; anything else raises.  x, dt, Bm and Cm are read
    through their strides (any layout, no alignment needed; the last
    dimension contiguous is the fast case); A and h0 must be contiguous.
    The kernel takes state <= 64 and B <= 65535 and raises on anything else
    rather than copy.
    """
    _check(x, dt, Bm, Cm, A, h0)
    dev = x.device
    if dev.type == "cpu":
        return selective_scan_ref(x, dt, Bm, Cm, A, h0)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan runs on cuda or cpu tensors, got {dev}")
    check_launch(x, A, h0)
    b, t, inner = x.shape
    state = A.shape[1]
    y = torch.empty((b, t, inner), dtype=torch.float32, device=dev)
    h_fin = torch.empty((b, inner, state), dtype=torch.float32, device=dev)
    if t == 0 or b == 0 or inner == 0:
        h_fin.copy_(h0)
        return y, h_fin
    lib = LIBRARY.load()
    err = call_on_device(
        dev.index, lib.selective_scan_launch,
        x.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), A.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_fin.data_ptr(), b, t, inner, state,
        *x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(), stream_handle(dev.index))
    if err != 0:
        raise RuntimeError(f"selective_scan kernel launch failed: CUDA error {err}")
    selective_scan_cuda.launches += 1
    return y, h_fin


selective_scan_cuda.launches = 0
