"""CUDA kernel for Hopper: the fleet state-at-time segment lookup.

Replaces the TPU kernel ``src/repro/kernels/fleet_state/kernel.py``
(``segment_index_pallas``), which counts each query against all S segments
because Mosaic cannot gather.  The source is
``src/repro_torch/csrc/fleet_state.cu``: one thread per query, a binary
search for the query's upper bound in the lexicographically sorted segment
triples — exactly the masked count, in O(log S) per query.  Each segment is
one 16-byte record, so a probe is one load.  Its header gives
the bound on the card (bytes: 16·N + 12·S).

``LIBRARY`` builds the source with ``nvcc`` at first use into
``build/kernels/`` (:mod:`repro_torch.kernels._build`).  Nothing is built
when this module is imported.

:func:`segment_index_cuda` launches the kernel for CUDA tensors and takes the
plain version (:func:`~repro_torch.kernels.fleet_state.ref.segment_index_ref`)
only for CPU tensors; any other device raises.  It does not check the
segments' order: :func:`~repro_torch.kernels.fleet_state.ops.upload_segments`
does, once per trace and device, and packs the records.  ``segment_index_cuda.launches`` counts
kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING, Tuple

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.fleet_state.ref import segment_index_ref

if TYPE_CHECKING:
    from repro_torch.kernels.fleet_state.ops import SegmentTable

THREADS = 256             # fleet_state.cu THREADS
MAX_N = 2**31 - 1 - THREADS


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.segment_index_launch
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("fleet_state", _bind)


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the segments on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def segment_index_cuda(segs: "SegmentTable", src: torch.Tensor,
                       qi: torch.Tensor, qf: torch.Tensor) -> torch.Tensor:
    """Segments ``segs`` (a :class:`~repro_torch.kernels.fleet_state.ops.SegmentTable`,
    sorted lexicographically); queries ``src``/``qi`` (N,) int32, ``qf``
    (N,) float32 -> (N,) int32 global segment indices.

    CUDA tensors launch the kernel on ``segs.rec`` (and count the launch);
    CPU tensors take the plain version on ``segs.dev/ti/tf``; anything else
    raises.
    """
    rec = segs.rec
    dev = rec.device
    if dev.type == "cpu":
        return segment_index_ref(segs.dev, segs.ti, segs.tf, src, qi, qf)
    if dev.type != "cuda":
        raise ValueError(f"fleet_state runs on cuda or cpu tensors, got {dev}")
    s, n = rec.shape[0], src.shape[0]
    if s < 1:
        raise ValueError("fleet_state needs at least one segment")
    if n > MAX_N:
        raise ValueError(f"fleet_state kernel takes N <= {MAX_N}, got {n}")
    _check("segs.rec", rec, (s, 4), torch.int32, dev)
    if rec.data_ptr() % 16:
        raise ValueError("segs.rec must be 16-byte aligned")
    for name, t, dtype in (("src", src, torch.int32), ("qi", qi, torch.int32),
                           ("qf", qf, torch.float32)):
        _check(name, t, (n,), dtype, dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.segment_index_launch(
            rec.data_ptr(), s, src.data_ptr(), qi.data_ptr(), qf.data_ptr(), n,
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fleet_state kernel launch failed: CUDA error {err}")
    segment_index_cuda.launches += 1
    return out


segment_index_cuda.launches = 0
