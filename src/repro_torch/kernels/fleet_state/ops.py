"""Public op: the fused fleet "state-at-time + next-transition" trace lookup.

:func:`segment_index` is the segment lookup of compiled trace timelines —
:meth:`repro_torch.fl.traces.trace.Trace.states_at` routes through it, so
every trace-driven mask and load query of the simulator hits one
implementation.  The tensors' device decides which runs: on the card the
CUDA kernel (:func:`~repro_torch.kernels.fleet_state.kernel.segment_index_cuda`),
on the CPU its plain version.

A trace's segment arrays are split once (:func:`_split_times`), checked for
sortedness and against the trace's CSR offsets, and uploaded once per device
(:func:`upload_segments`, cached by
:meth:`~repro_torch.fl.traces.trace.Trace.resident`); each call wraps and
splits its queries on the host and makes one upload and one download
(:func:`~repro_torch.kernels.fleet_state.kernel.segment_index_lookup`).  The
period wrap, the f64 next-flip arithmetic of :func:`fleet_state_at` and the
int64 result stay numpy on the host, exactly as in the reference, so the
virtual clock never loses whole-second exactness to f32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.fleet_state.kernel import (  # noqa: F401 (re-exported)
    SegmentTable,
    pack_queries,
    segment_index_lookup,
)
from repro_torch.obs.profiling import timed_call

# the bucket table's entries, at most (64 MB of int32)
MAX_BUCKET_ENTRIES = 1 << 24


def _split_times(t: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact int32 whole-second + f32 fraction split of f64 trace times.
    Compared lexicographically this is exact for whole-second segment starts
    (what ``compile_events`` ingests) against any fractional query time."""
    ti = np.floor(t)
    return ti.astype(np.int32), (t - ti).astype(np.float32)


def check_sorted(seg_dev: np.ndarray, seg_ti: np.ndarray,
                 seg_tf: np.ndarray) -> None:
    """Raise unless the (dev, ti, tf) triples are lexicographically
    non-decreasing — the order the kernel's binary search relies on."""
    dd, di = np.diff(seg_dev.astype(np.int64)), np.diff(seg_ti.astype(np.int64))
    df = np.diff(seg_tf)
    ok = (dd > 0) | ((dd == 0) & ((di > 0) | ((di == 0) & (df >= 0))))
    if not ok.all():
        bad = int(np.flatnonzero(~ok)[0])
        raise ValueError(f"trace segments are not sorted by (device, start) at "
                         f"segment {bad} -> {bad + 1}")


def _buckets(sdev: np.ndarray, sti: np.ndarray, n_dev: int) -> Tuple[np.ndarray, int]:
    """The kernel's per-device bucket table: K buckets of ``2**shift``
    seconds a device, K the average segments a device rounded up to a power
    of two (at most 4096, and at most ``MAX_BUCKET_ENTRIES`` in all),
    ``2**shift * K`` past every start; entry ``[d, k]`` is the global index
    of device ``d``'s first segment starting at or after ``k << shift`` (so
    column 0 and column K are the CSR offsets)."""
    s, d = len(sdev), max(n_dev, 1)
    k = 1 << min(12, max(0, (-(-s // d) - 1).bit_length()),
                 max(0, (MAX_BUCKET_ENTRIES // d).bit_length() - 2))
    span = int(sti.max()) + 1 if s else 1
    shift = max(0, (-(-span // k) - 1).bit_length())
    step = np.int64(k) << shift                    # > every start
    key = sdev.astype(np.int64) * (step + 1) + sti
    bounds = (np.arange(n_dev, dtype=np.int64)[:, None] * (step + 1)
              + (np.arange(k + 1, dtype=np.int64) << shift)[None, :])
    return np.searchsorted(key, bounds, side="left").astype(np.int32), shift


def upload_segments(seg_dev: np.ndarray, seg_t: np.ndarray, device: torch.device,
                    offsets: Optional[np.ndarray] = None) -> SegmentTable:
    """Split, check and upload a trace's segment arrays to ``device``, with
    the CSR offsets derived from the sorted ``seg_dev`` (raises if they
    differ from the trace's own ``offsets``, when given) and the kernel's
    per-device bucket table."""
    sdev = np.asarray(seg_dev, np.int64)
    if len(sdev) and (sdev.min() < 0 or sdev.max() > np.iinfo(np.int32).max - 1):
        raise ValueError("segment device indices must fit int32 and be >= 0")
    seg_t = np.asarray(seg_t, np.float64)
    if len(seg_t) and not (seg_t.min() >= 0 and seg_t.max() < 2.0**30):
        raise ValueError("segment start times must lie in [0, 2**30) seconds")
    sti, stf = _split_times(seg_t)
    sdev = sdev.astype(np.int32)
    check_sorted(sdev, sti, stf)
    n_dev = int(sdev[-1]) + 1 if len(sdev) else 0
    off = np.searchsorted(sdev, np.arange(n_dev + 1), side="left").astype(np.int32)
    if offsets is not None and not np.array_equal(off, np.asarray(offsets)):
        raise ValueError("the segments' CSR offsets differ from the trace's offsets")
    bkt, shift = _buckets(sdev, sti, n_dev)
    rec = np.stack([sdev, sti, stf.view(np.int32), np.zeros_like(sdev)], axis=1)
    return SegmentTable(torch.as_tensor(rec, device=device),
                        torch.as_tensor(off, device=device),
                        torch.as_tensor(bkt, device=device), shift)


def segment_index(segs: SegmentTable, period_s: float, src: np.ndarray,
                  t_s: np.ndarray) -> np.ndarray:
    """Global segment index (int64) of each ``(src, t_s)`` query (the two
    broadcast); times are wrapped into the period here, so callers pass
    absolute phase-shifted clocks."""
    tau = np.asarray(t_s, dtype=np.float64) % period_s
    src_b, tau_b = np.broadcast_arrays(np.asarray(src, dtype=np.int64), tau)
    qi, qf = _split_times(tau_b.reshape(-1))
    # timed_call is a passthrough unless a profiler is active
    # (repro_torch.obs.profiling); with one, every lookup's wall-clock lands
    # in the run record's op table under its route
    route = "cuda" if segs.device.type == "cuda" else "plain"
    idx = timed_call(f"fleet_state.{route}", segment_index_lookup, segs,
                     src_b.reshape(-1).astype(np.int32), qi, qf)
    return idx.astype(np.int64).reshape(src_b.shape)


def fleet_state_at(segs: SegmentTable, seg_state: np.ndarray,
                   flip_tau: Optional[np.ndarray], period_s: float,
                   src: np.ndarray, t_s: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Fused state + next-flip query.

    Returns ``(codes, next_flip_abs)``: per query the segment's state code,
    and the absolute time (same clock as ``t_s``) of the device's next
    online-status flip per the ``flip_tau`` table — ``inf`` where the status
    never changes.  One segment lookup; the f64 flip arithmetic is an O(N)
    gather on the host off the int32 indices.
    """
    t = np.asarray(t_s, dtype=np.float64)
    idx = segment_index(segs, period_s, src, t)
    codes = np.asarray(seg_state)[idx]
    if flip_tau is None:
        return codes, np.full(idx.shape, np.inf)
    tau = t % period_s
    flip = np.asarray(flip_tau, np.float64)[idx]
    return codes, np.where(np.isfinite(flip), (t - tau) + flip, np.inf)
