"""Public op: the fused fleet "state-at-time + next-transition" trace lookup.

:func:`segment_index` is the segment lookup of compiled trace timelines —
:meth:`repro_torch.fl.traces.trace.Trace.states_at` routes through it, so
every trace-driven mask and load query of the simulator hits one
implementation.  The tensors' device decides which runs: on the card the
CUDA kernel (:func:`~repro_torch.kernels.fleet_state.kernel.segment_index_cuda`),
on the CPU its plain version.

A trace's segment arrays are split once (:func:`_split_times`), checked for
sortedness and uploaded once per device (:func:`upload_segments`, cached by
:meth:`~repro_torch.fl.traces.trace.Trace.resident`); the queries are split
and uploaded per call.  The period wrap, the f64 next-flip arithmetic of
:func:`fleet_state_at` and the int64 result stay numpy on the host, exactly
as in the reference, so the virtual clock never loses whole-second
exactness to f32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.fleet_state.kernel import segment_index_cuda


class SegmentTable(NamedTuple):
    """A trace's split segment starts on one device, lexicographically
    sorted: ``rec`` (S, 4) int32 holds one 16-byte record per segment
    (device index, whole seconds, the float32 fraction's bits, 0), which the
    kernel reads; ``dev``/``ti`` (int32) and ``tf`` (float32) are views of
    its columns, which the plain version reads."""

    rec: torch.Tensor
    dev: torch.Tensor
    ti: torch.Tensor
    tf: torch.Tensor


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


def upload_segments(seg_dev: np.ndarray, seg_t: np.ndarray,
                    device: torch.device) -> SegmentTable:
    """Split, check and upload a trace's segment arrays to ``device``."""
    sdev = np.asarray(seg_dev, np.int64)
    if len(sdev) and (sdev.min() < 0 or sdev.max() > np.iinfo(np.int32).max):
        raise ValueError("segment device indices must fit int32 and be >= 0")
    sti, stf = _split_times(np.asarray(seg_t, np.float64))
    sdev = sdev.astype(np.int32)
    check_sorted(sdev, sti, stf)
    rec = np.stack([sdev, sti, stf.view(np.int32), np.zeros_like(sdev)], axis=1)
    rec = torch.as_tensor(rec, device=device)
    return SegmentTable(rec, rec[:, 0], rec[:, 1], rec[:, 2].view(torch.float32))


def segment_index(segs: SegmentTable, period_s: float, src: np.ndarray,
                  t_s: np.ndarray) -> np.ndarray:
    """Global segment index (int64) of each ``(src, t_s)`` query (the two
    broadcast); times are wrapped into the period here, so callers pass
    absolute phase-shifted clocks."""
    tau = np.asarray(t_s, dtype=np.float64) % period_s
    src_b, tau_b = np.broadcast_arrays(np.asarray(src, dtype=np.int64), tau)
    qi, qf = _split_times(tau_b.reshape(-1))
    dev = segs.dev.device
    idx = segment_index_cuda(
        segs,
        torch.as_tensor(src_b.reshape(-1).astype(np.int32), device=dev),
        torch.as_tensor(qi, device=dev), torch.as_tensor(qf, device=dev))
    return idx.cpu().numpy().astype(np.int64).reshape(src_b.shape)


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
