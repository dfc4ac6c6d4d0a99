"""CUDA kernel for Hopper: flash attention (prefill), GQA, causal and
sliding-window masks.

Replaces the TPU kernel ``src/repro/kernels/flash_attention/kernel.py:93``
(``flash_attention_folded``), which folds the G query heads of a KV group
into its rows and walks the key blocks on a sequential grid axis.  The
source is ``src/repro_torch/csrc/flash_attention.cu``: one CTA per (batch,
KV head, block of 64 / G query positions) takes all G heads of the group,
reads q, k and v in place through their strides (no fold, no transposed
copies) and loops over the key tiles it needs, skipping those wholly in the
future or outside the window; fp32 (m, l, acc), the reference's finite
``NEG_INF`` masking, ragged last tiles masked, so any S >= 1.  Its header
gives the bound on the card.

The source holds two kernels behind one entry; :func:`flash_route` picks
one from the dtype and Dh alone: ``"mma"`` (``flash_fwd_mma_kernel``, bf16
with Dh <= 128: ``mma.sync`` on the tensor cores, fp32 sums, P split into
bf16 high and low parts) or ``"fma"`` (``flash_fwd_kernel``: fp32 inputs,
and bf16 with Dh > 128, fp32 FMAs on the CUDA cores).  Nothing falls back
from one to the other.

``LIBRARY`` builds the source with ``nvcc`` at first use into
``build/kernels/`` (:mod:`repro_torch.kernels._build`).  Nothing is built
when this module is imported.

:func:`flash_attention_cuda` launches the kernel for CUDA tensors and takes
the plain version (:func:`~repro_torch.kernels.flash_attention.ref.attention_ref`)
only for CPU tensors; any other device raises.  ``flash_attention_cuda.launches``
counts kernel launches of both routes, ``flash_attention_cuda.mma_launches``
those of the tensor-core route.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.flash_attention.ref import attention_ref

ROWS = 64                 # flash_attention.cu ROWS: (position, head) rows per CTA
MAX_DH = 256
MMA_MAX_DH = 128          # the tensor-core kernel's widest head (padded to 64 or 128)
MAX_GRID_YZ = 65535
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTE_CODES = {"fma": 0, "mma": 1}


def flash_route(dtype: torch.dtype, dh: int) -> str:
    """The kernel a launch takes: ``"mma"`` (tensor cores) for bf16 with
    Dh <= 128, ``"fma"`` (CUDA cores) for everything else the wrapper
    accepts (fp32, and bf16 with 128 < Dh <= 256)."""
    return "mma" if dtype == torch.bfloat16 and dh <= MMA_MAX_DH else "fma"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention", _bind)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes q (B, S, H, Dh), k/v (B, S, KV, Dh)")
    b, s, h, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, s) or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    kv = k.shape[2]
    if kv < 1 or h % kv:
        raise ValueError(f"{h} query heads do not split into groups over {kv} KV heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"q, k, v must share a dtype: {q.dtype}, {k.dtype}, {v.dtype}")


def check_launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """What the kernels refuse that shapes, dtypes and strides show, without
    data: dtypes other than fp32 and bf16, H / KV > 64, Dh > 256, B or KV >
    65535, a last dimension that is not contiguous.  The op's fake
    implementation runs it too, so a dry-run refuses what the card would."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"flash_attention kernel takes {list(DTYPE_CODES)}, got {q.dtype}")
    b, s, h, dh = q.shape
    kv = k.shape[2]
    if h // kv > ROWS:
        raise ValueError(f"flash_attention kernel takes H / KV <= {ROWS}, got {h // kv}")
    if dh > MAX_DH:
        raise ValueError(f"flash_attention kernel takes Dh <= {MAX_DH}, got {dh}")
    if b > MAX_GRID_YZ or kv > MAX_GRID_YZ:
        raise ValueError(f"flash_attention kernel takes B, KV <= {MAX_GRID_YZ}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q (B, S, H, Dh), k/v (B, S, KV, Dh) -> (B, S, H, Dh) in q's dtype.

    CUDA tensors launch the kernel that :func:`flash_route` names (and count
    the launch); CPU tensors take the plain version; anything else raises.
    The kernels take fp32 and bf16, H / KV <= 64, Dh <= 256 and B, KV <=
    65535, with the last dimension contiguous and every row, stride and base
    16-byte aligned; the wrapper raises on anything else rather than copy.
    """
    _check(q, k, v, window)
    dev = q.device
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu tensors, got {dev}")
    if k.device != dev or v.device != dev:
        raise ValueError(f"q is on {dev}, k on {k.device}, v on {v.device}")
    check_launch(q, k, v)
    b, s, h, dh = q.shape
    kv = k.shape[2]
    esz = q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (dh * esz) % 16 or any((st * esz) % 16 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"{name}: rows ({dh} x {esz} bytes), strides {t.stride()} and base "
                "must be 16-byte aligned for the flash_attention kernel")
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    route = flash_route(q.dtype, dh)
    lib = LIBRARY.load()
    with torch.cuda.device(dev):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPE_CODES[q.dtype], b, s, h, kv, dh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), int(window or 0), ROUTE_CODES[route],
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch ({route}) failed: "
                           f"CUDA error {err}")
    flash_attention_cuda.launches += 1
    if route == "mma":
        flash_attention_cuda.mma_launches += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.mma_launches = 0
