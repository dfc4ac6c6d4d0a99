"""CUDA kernels for Hopper: the pairwise RankNet loss and its score gradient.

Replaces the TPU kernel ``src/repro/kernels/pairwise_rank/kernel.py``
(``pairwise_rank_pallas``), which is forward-only; the gradient is a kernel
here as well.  The source is ``src/repro_torch/csrc/pairwise_rank.cu``; its
header comment gives the bound on the card (per-pair fp32 operations,
transcendentals counted as one each) and the design: one thread per row i
looping over shared-memory column tiles, fp32 tile sums added into fp64 row
sums, then fixed-order reductions (no atomics, deterministic).

``LIBRARY`` builds the source with ``nvcc`` at first use into
``build/kernels/`` (:mod:`repro_torch.kernels._build`).  Nothing is built
when this module is imported.

Both wrappers launch their kernel for CUDA tensors and take the plain
version (:mod:`repro_torch.kernels.pairwise_rank.ref`) only for CPU tensors;
any other device raises.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.pairwise_rank.ref import pairwise_rank_ref, pairwise_rank_sums

ROWS = 128            # rows per CTA (pairwise_rank.cu ROWS)
MAX_N = 2**31 - 1 - ROWS


def _bind(lib: ctypes.CDLL) -> None:
    fwd = lib.pairwise_rank_fwd_launch
    fwd.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p] * 4)
    fwd.restype = ctypes.c_int
    bwd = lib.pairwise_rank_bwd_launch
    bwd.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                    + [ctypes.c_void_p] * 2)
    bwd.restype = ctypes.c_int


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
    if scores.dim() != 2:
        raise ValueError(f"scores must be (B, N), got shape {tuple(scores.shape)}")
    b, n = scores.shape
    if not (b >= 1 and 1 <= n <= MAX_N):
        raise ValueError(f"pairwise_rank kernels take B >= 1 and "
                         f"1 <= N <= {MAX_N}, got B={b}, N={n}")
    for name, t in (("scores", scores), ("targets", targets), ("mask", mask)):
        _check(name, t, (b, n), torch.float32, scores.device)
    return b, n


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def pairwise_rank_fwd_cuda(scores: torch.Tensor, targets: torch.Tensor,
                           mask: torch.Tensor, *, hard: bool
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores, targets, mask (B, N) float32 -> (loss (B,) float32, count
    (B,) float64): each row's mean pair BCE and its pair count (what the
    gradient scales by).

    CUDA tensors launch the kernel (and count the launch); CPU tensors take
    the plain version; anything else raises.
    """
    if _device_of(scores) == "cpu":
        total, count = pairwise_rank_sums(scores, targets, mask, hard)
        return total / torch.clamp(count, min=1.0), count.double()
    b, n = _check_inputs(scores, targets, mask)
    dev = scores.device
    lib = LIBRARY.load()
    n_blocks = -(-n // ROWS)
    scratch = torch.empty(2 * b * n_blocks, dtype=torch.float64, device=dev)
    loss = torch.empty(b, dtype=torch.float32, device=dev)
    count = torch.empty(b, dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = lib.pairwise_rank_fwd_launch(
            scores.data_ptr(), targets.data_ptr(), mask.data_ptr(), b, n,
            int(bool(hard)), scratch.data_ptr(), loss.data_ptr(),
            count.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"pairwise_rank_fwd launch failed: CUDA error {err}")
    pairwise_rank_fwd_cuda.launches += 1
    return loss, count


pairwise_rank_fwd_cuda.launches = 0


def pairwise_rank_bwd_cuda(scores: torch.Tensor, targets: torch.Tensor,
                           mask: torch.Tensor, count: torch.Tensor,
                           grad_loss: torch.Tensor, *, hard: bool
                           ) -> torch.Tensor:
    """d(sum_b grad_loss_b * loss_b)/d scores, (B, N) float32; ``count`` is
    the forward's (B,) float64 pair count, ``grad_loss`` (B,) float32.

    CUDA tensors launch the kernel (and count the launch); CPU tensors take
    autograd of the plain version; anything else raises.
    """
    if _device_of(scores) == "cpu":
        with torch.enable_grad():
            s = scores.detach().requires_grad_(True)
            loss = pairwise_rank_ref(s, targets.detach(), mask.detach(), hard)
            (grad,) = torch.autograd.grad(loss, s, grad_loss)
        return grad
    b, n = _check_inputs(scores, targets, mask)
    dev = scores.device
    _check("count", count, (b,), torch.float64, dev)
    _check("grad_loss", grad_loss, (b,), torch.float32, dev)
    lib = LIBRARY.load()
    grad = torch.empty((b, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pairwise_rank_bwd_launch(
            scores.data_ptr(), targets.data_ptr(), mask.data_ptr(),
            count.data_ptr(), grad_loss.data_ptr(), b, n, int(bool(hard)),
            grad.data_ptr(), _stream(dev))
    if err != 0:
        raise RuntimeError(f"pairwise_rank_bwd launch failed: CUDA error {err}")
    pairwise_rank_bwd_cuda.launches += 1
    return grad


pairwise_rank_bwd_cuda.launches = 0
