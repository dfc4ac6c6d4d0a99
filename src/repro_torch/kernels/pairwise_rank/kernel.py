"""CUDA kernels for Hopper: the pairwise RankNet loss and its score gradient.

Replaces the TPU kernel ``src/repro/kernels/pairwise_rank/kernel.py``
(``pairwise_rank_pallas``), which is forward-only; here the gradient comes
out of the same launch.  The source is ``src/repro_torch/csrc/pairwise_rank.cu``;
its header comment gives the bound on the card (per-pair fp32 operations,
transcendentals counted as one each) and the design: cohorts of N <= 32 one
lane group each (shuffles, no scratch), larger ones on a 2-D grid of row
tiles x column chunks whose last CTA per cohort, by an integer ticket, adds
the partials in a fixed order (no float atomics, deterministic).

``LIBRARY`` builds the source with ``nvcc`` at first use into
``build/kernels/`` (:mod:`repro_torch.kernels._build`).  Nothing is built
when this module is imported.

Two wrappers, each counting its launches in ``<wrapper>.launches``:

* :func:`pairwise_rank_fused_cuda`: loss, pair count and the gradient in
  one launch (what a training step calls);
* :func:`pairwise_rank_fwd_cuda`: loss and pair count, one launch (under
  ``torch.no_grad``).

Each launches its kernel for CUDA tensors and takes the plain version
(:mod:`repro_torch.kernels.pairwise_rank.ref`) only for CPU tensors; any
other device raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaLibrary, call_on_device, stream_handle
from repro_torch.kernels.pairwise_rank.ref import pairwise_rank_fused_ref, pairwise_rank_sums

ROWS = 128            # rows per CTA (pairwise_rank.cu ROWS)
GROUP_MAX = 32        # N at most this takes the group kernel, no scratch
MAX_N = 2**31 - 1 - ROWS


def _bind(lib: ctypes.CDLL) -> None:
    size = lib.pairwise_rank_scratch_bytes
    size.argtypes = [ctypes.c_int] * 3
    size.restype = ctypes.c_longlong
    fused = lib.pairwise_rank_launch
    fused.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                      + [ctypes.c_void_p] * 5)
    fused.restype = ctypes.c_int


LIBRARY = CudaLibrary("pairwise_rank", _bind)


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           dtype: torch.dtype, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, scores on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(scores: torch.Tensor) -> str:
    kind = scores.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"pairwise_rank runs on cuda or cpu tensors, got "
                         f"{scores.device}")
    return kind


def _check_inputs(scores, targets, mask) -> Tuple[int, int]:
    shape, index = scores.shape, scores.get_device()
    if len(shape) == 2 and shape[0] >= 1 and 1 <= shape[1] <= MAX_N and all(
            t.dtype is torch.float32 and t.shape == shape and t.get_device() == index
            and t.is_contiguous() for t in (scores, targets, mask)):
        return shape[0], shape[1]
    # what is wrong, for the error
    if scores.dim() != 2:
        raise ValueError(f"scores must be (B, N), got shape {tuple(scores.shape)}")
    b, n = scores.shape
    if not (b >= 1 and 1 <= n <= MAX_N):
        raise ValueError(f"pairwise_rank kernels take B >= 1 and "
                         f"1 <= N <= {MAX_N}, got B={b}, N={n}")
    for name, t in (("scores", scores), ("targets", targets), ("mask", mask)):
        _check(name, t, (b, n), torch.float32, scores.device)
    return b, n


def _launch(scores, targets, mask, hard, grad: bool):
    """One launch of ``pairwise_rank_launch``: (loss, count, grad or None)."""
    b, n = _check_inputs(scores, targets, mask)
    dev = scores.device
    lib = LIBRARY.load()
    scratch = None
    if n > GROUP_MAX:
        nbytes = lib.pairwise_rank_scratch_bytes(b, n, int(grad))
        if nbytes < 0:
            raise RuntimeError(f"pairwise_rank scratch query failed for B={b}, N={n}")
        scratch = torch.zeros(nbytes, dtype=torch.uint8, device=dev)   # tickets start at 0
    loss = torch.empty(b, dtype=torch.float32, device=dev)
    count = torch.empty(b, dtype=torch.float64, device=dev)
    out = torch.empty((b, n), dtype=torch.float32, device=dev) if grad else None
    index = dev.index
    err = call_on_device(
        index, lib.pairwise_rank_launch, scores.data_ptr(), targets.data_ptr(),
        mask.data_ptr(), b, n, int(bool(hard)), int(grad),
        None if scratch is None else scratch.data_ptr(), loss.data_ptr(),
        count.data_ptr(), None if out is None else out.data_ptr(), stream_handle(index))
    if err != 0:
        raise RuntimeError(f"pairwise_rank launch failed: CUDA error {err}")
    return loss, count, out


def pairwise_rank_fused_cuda(scores: torch.Tensor, targets: torch.Tensor,
                             mask: torch.Tensor, *, hard: bool
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """scores, targets, mask (B, N) float32 -> (loss (B,) float32, count
    (B,) float64, grad (B, N) float32): each row's mean pair BCE, its pair
    count, and the gradient of its loss with respect to its scores,
    ``2 / max(count, 1) * sum_j pm_ij (sigmoid(s_i - s_j) - tgt_ij)``.

    CUDA tensors make one launch (and count it); CPU tensors take the plain
    version; anything else raises.
    """
    if _device_of(scores) == "cpu":
        return pairwise_rank_fused_ref(scores, targets, mask, hard)
    loss, count, grad = _launch(scores, targets, mask, hard, True)
    pairwise_rank_fused_cuda.launches += 1
    return loss, count, grad


pairwise_rank_fused_cuda.launches = 0


def pairwise_rank_fwd_cuda(scores: torch.Tensor, targets: torch.Tensor,
                           mask: torch.Tensor, *, hard: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores, targets, mask (B, N) float32 -> (loss (B,) float32, count
    (B,) float64): each row's mean pair BCE and its pair count (what the
    gradient scales by).

    CUDA tensors make one launch (and count it); CPU tensors take the plain
    version; anything else raises.
    """
    if _device_of(scores) == "cpu":
        total, count = pairwise_rank_sums(scores, targets, mask, hard)
        return total / torch.clamp(count, min=1.0), count.double()
    loss, count, _ = _launch(scores, targets, mask, hard, False)
    pairwise_rank_fwd_cuda.launches += 1
    return loss, count


pairwise_rank_fwd_cuda.launches = 0
