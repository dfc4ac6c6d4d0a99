"""CUDA kernel for Hopper: the fleet state-at-time segment lookup.

Replaces the TPU kernel ``src/repro/kernels/fleet_state/kernel.py``
(``segment_index_pallas``), which counts each query against all S segments
because Mosaic cannot gather.  The source is
``src/repro_torch/csrc/fleet_state.cu``: per query a binary search for its
upper bound within its own device's sorted segments, narrowed by a
per-device bucket table to those of one time bucket — exactly the masked
count, in ~1-2 probes of one 16-byte record each.  Its header gives the
bound on the card (bytes: 16·N + 12·S).

``LIBRARY`` builds the source with ``nvcc`` at first use into
``build/kernels/`` (:mod:`repro_torch.kernels._build`).  Nothing is built
when this module is imported.

A :class:`SegmentTable` is a trace's segments on one device.  Everything a
launch needs that does not change between calls is resolved once per table,
on its first launch (:meth:`SegmentTable.plan`): the library, its bound
entry points, the device index, the pointers and the grid.  Two entries
launch the kernel, and both count into ``segment_index_cuda.launches``:

* :func:`segment_index_cuda` takes packed query records already on the
  table's device and returns a device tensor;
* :func:`segment_index_lookup` takes host arrays and returns a host array:
  it packs the queries into a pinned buffer that the table keeps, and one C
  call makes one upload, the launch, one download into pinned memory and one
  stream synchronise.  This is what the trace layer calls every round.

Both take the plain version
(:func:`~repro_torch.kernels.fleet_state.ref.segment_index_ref`) for a table
on the CPU; any other device raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels._build import CudaLibrary, call_on_device, stream_handle
from repro_torch.kernels.fleet_state.ref import segment_index_ref

MAX_N = 2**31 - 1


def _bind(lib: ctypes.CDLL) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_index_plan.argtypes = [i, i, i, i, ctypes.POINTER(i)]
    lib.segment_index_plan.restype = i
    lib.segment_index_launch.argtypes = [vp, i, vp, i, i, i, i, vp, i, vp, vp]
    lib.segment_index_launch.restype = i
    lib.segment_index_lookup.argtypes = [vp, i, vp, i, i, i, i, vp, vp, i, vp, vp, vp]
    lib.segment_index_lookup.restype = i


LIBRARY = CudaLibrary("fleet_state", _bind)


def pack_queries(src: np.ndarray, qi: np.ndarray, qf: np.ndarray,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """(N, 4) int32 query records (source device, whole seconds, the float32
    fraction's bits, 0), written into ``out`` when given."""
    n = len(src)
    rec = np.empty((n, 4), np.int32) if out is None else out[:n]
    rec[:, 0] = src
    rec[:, 1] = qi
    rec[:, 2] = np.asarray(qf, np.float32).view(np.int32)
    rec[:, 3] = 0
    return rec


class _Plan:
    """What every launch on one table reuses."""

    __slots__ = ("launch", "lookup", "index", "device", "table")


class _Buffers:
    """Pinned host and device buffers for up to ``cap`` queries, with their
    pointers."""

    __slots__ = ("cap", "tensors", "host_q", "host_out", "ptrs")

    def __init__(self, cap: int, device: torch.device):
        hq = torch.empty((cap, 4), dtype=torch.int32, pin_memory=True)
        hout = torch.empty(cap, dtype=torch.int32, pin_memory=True)
        dq = torch.empty((cap, 4), dtype=torch.int32, device=device)
        dout = torch.empty(cap, dtype=torch.int32, device=device)
        self.cap, self.tensors = cap, (hq, dq, dout, hout)     # kept alive
        self.host_q, self.host_out = hq.numpy(), hout.numpy()
        self.ptrs = tuple(t.data_ptr() for t in self.tensors)


class SegmentTable:
    """A trace's split segment starts on one device, lexicographically
    sorted.  ``rec`` (S, 4) int32 holds one 16-byte record per segment
    (device index, whole seconds, the float32 fraction's bits, 0),
    ``offsets`` (D + 1,) int32 the CSR offsets of each device's segments,
    and ``buckets`` (D, K + 1) int32 their refinement into K buckets of
    ``2**bucket_shift`` seconds (``buckets[d, k]`` is the first segment of
    device ``d`` starting at or after ``k << bucket_shift``, so columns 0
    and K are the offsets); the kernel reads ``rec`` and ``buckets``.  ``dev``/``ti`` (int32) and ``tf`` (float32) are views of
    ``rec``'s columns, which the plain version reads.  Build one with
    :func:`~repro_torch.kernels.fleet_state.ops.upload_segments`, which
    checks the order and the offsets."""

    def __init__(self, rec: torch.Tensor, offsets: torch.Tensor,
                 buckets: torch.Tensor, bucket_shift: int):
        self.rec, self.offsets = rec, offsets
        self.buckets, self.bucket_shift = buckets, bucket_shift
        self.dev, self.ti = rec[:, 0], rec[:, 1]
        self.tf = rec[:, 2].view(torch.float32)
        self._plan: Optional[_Plan] = None
        self._buffers: Optional[_Buffers] = None

    @property
    def device(self) -> torch.device:
        return self.rec.device

    def plan(self) -> _Plan:
        """Resolve the library, entry points, device, pointers and grid once
        (the table's tensors never move)."""
        if self._plan is None:
            rec, off = self.rec, self.offsets
            if rec.device.type != "cuda":
                raise ValueError(f"fleet_state runs on cuda or cpu tensors, got {rec.device}")
            bkt = self.buckets
            s, d, k = rec.shape[0], off.shape[0] - 1, bkt.shape[1] - 1
            if s < 1:
                raise ValueError("fleet_state needs at least one segment")
            for name, t, shape in (("rec", rec, (s, 4)), ("offsets", off, (d + 1,)),
                                   ("buckets", bkt, (d, k + 1))):
                if (t.dtype != torch.int32 or tuple(t.shape) != shape
                        or not t.is_contiguous() or t.device != rec.device):
                    raise ValueError(f"segs.{name} must be contiguous int32 {shape} "
                                     f"on {rec.device}")
            if rec.data_ptr() % 16:
                raise ValueError("segs.rec must be 16-byte aligned")
            lib = LIBRARY.load()
            blocks = ctypes.c_int(0)
            index = rec.device.index
            err = call_on_device(index, lib.segment_index_plan, s, d, k,
                                 self.bucket_shift, ctypes.byref(blocks))
            if err != 0:
                raise RuntimeError(f"fleet_state launch plan failed: CUDA error {err}")
            p = _Plan()
            p.launch, p.lookup = lib.segment_index_launch, lib.segment_index_lookup
            p.index, p.device = index, rec.device
            # the leading arguments of both entries, the same on every call
            p.table = (rec.data_ptr(), s, bkt.data_ptr(), d, k, self.bucket_shift,
                       blocks.value)
            self._plan = p
        return self._plan

    def buffers(self, n: int) -> _Buffers:
        """Pinned host and device buffers for ``n`` queries, grown to the
        next power of two on demand and kept."""
        if self._buffers is None or self._buffers.cap < n:
            self._buffers = _Buffers(1 << max(10, (n - 1).bit_length()), self.device)
        return self._buffers


def _plain(segs: SegmentTable, q: torch.Tensor) -> torch.Tensor:
    return segment_index_ref(segs.dev, segs.ti, segs.tf, q[:, 0], q[:, 1],
                             q[:, 2].view(torch.float32))


def segment_index_cuda(segs: SegmentTable, queries: torch.Tensor) -> torch.Tensor:
    """Segments ``segs``; queries (N, 4) int32 records from
    :func:`pack_queries` on the table's device -> (N,) int32 global segment
    indices.

    A table on the card launches the kernel (and counts the launch); on the
    CPU it takes the plain version; anything else raises.
    """
    p = segs._plan
    if p is None:
        if segs.device.type == "cpu":
            return _plain(segs, queries)
        p = segs.plan()
    n = queries.shape[0]
    if not (queries.get_device() == p.index
            and queries.dtype == torch.int32 and queries.dim() == 2
            and queries.shape[1] == 4 and queries.is_contiguous()):
        raise ValueError(f"queries must be contiguous int32 (N, 4) on {segs.device}, got "
                         f"{queries.dtype} {tuple(queries.shape)} on {queries.device}")
    out = torch.empty(n, dtype=torch.int32, device=p.device)
    if n == 0:
        return out
    q_ptr = queries.data_ptr()
    if q_ptr % 16 or n > MAX_N:
        raise ValueError(f"queries must be 16-byte aligned and at most {MAX_N}")
    err = call_on_device(p.index, p.launch, *p.table, q_ptr, n, out.data_ptr(),
                         stream_handle(p.index))
    if err != 0:
        raise RuntimeError(f"fleet_state kernel launch failed: CUDA error {err}")
    segment_index_cuda.launches += 1
    return out


segment_index_cuda.launches = 0


def segment_index_lookup(segs: SegmentTable, src: np.ndarray, qi: np.ndarray,
                         qf: np.ndarray) -> np.ndarray:
    """Host queries ``src``/``qi`` (N,) int32 and ``qf`` (N,) float32 ->
    (N,) int32 global segment indices on the host, a fresh array.

    A table on the card makes one upload, one launch (counted in
    ``segment_index_cuda.launches``), one download and one synchronise; on
    the CPU it takes the plain version.
    """
    n = len(src)
    p = segs._plan
    if p is None:
        if segs.device.type == "cpu":
            return _plain(segs, torch.as_tensor(pack_queries(src, qi, qf))).numpy()
        p = segs.plan()
    if n == 0:
        return np.empty(0, np.int32)
    if n > MAX_N:
        raise ValueError(f"fleet_state kernel takes N <= {MAX_N}, got {n}")
    buf = segs.buffers(n)
    pack_queries(src, qi, qf, out=buf.host_q)
    hq, dq, dout, hout = buf.ptrs
    err = call_on_device(p.index, p.lookup, *p.table, hq, dq, n, dout, hout,
                         stream_handle(p.index))
    if err != 0:
        raise RuntimeError(f"fleet_state lookup failed: CUDA error {err}")
    segment_index_cuda.launches += 1
    return buf.host_out[:n].copy()
