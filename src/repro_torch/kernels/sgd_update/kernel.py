"""CUDA kernel for Hopper: the SGD update of a stacked leaf in one pass.

Replaces no TPU kernel: the reference's client step
(``src/repro/fl/client.py:157-159``) is fused by XLA inside its
``lax.scan``; this is that fused pass for the port's vmapped executor, which
ran it as five fp32 elementwise passes and a per-client copy.  The source,
``src/repro_torch/csrc/sgd_update.cu``, reads a and g once and writes the
updated leaf once, in 16-byte vectors, bit-identical to the plain version
(:func:`~repro_torch.kernels.sgd_update.ref.sgd_update_ref`).  A broadcast
``a`` (client stride 0) is read once for all clients.  Its header gives the
bound on the card.

``LIBRARY`` builds the source with ``nvcc`` at first use into
``build/kernels/`` (:mod:`repro_torch.kernels._build`).  Nothing is built
when this module is imported.

:func:`sgd_update_cuda` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; any other device raises.
``sgd_update_cuda.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaLibrary, call_on_device, stream_handle
from repro_torch.kernels.sgd_update.ref import sgd_update_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.sgd_update_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_longlong] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    cfg = lib.sgd_update_config
    cfg.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    cfg.restype = ctypes.c_int


LIBRARY = CudaLibrary("sgd_update", _bind)


def _check(a: torch.Tensor, g: torch.Tensor) -> None:
    if a.dtype not in DTYPES:
        raise ValueError(f"sgd_update takes float32, bfloat16 or float16 leaves; a is {a.dtype}")
    if g.dtype != a.dtype:
        raise ValueError(f"g is {g.dtype}, a {a.dtype}")
    if g.device != a.device:
        raise ValueError(f"g is on {g.device}, a on {a.device}")
    if a.dim() < 1:
        raise ValueError("sgd_update takes a leaf with a leading client axis, got a scalar")
    if g.shape != a.shape:
        raise ValueError(f"g has shape {tuple(g.shape)}, a {tuple(a.shape)}")


def _client_block_contiguous(t: torch.Tensor) -> bool:
    """Each client's block ``t[j]`` is contiguous (whatever the client
    stride)."""
    want = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != want:
            return False
        want *= size
    return True


def check_launch(a: torch.Tensor, g: torch.Tensor) -> None:
    """What the kernel refuses that shapes and strides show, without data:
    a client's block of a or g that is not contiguous.  The op's fake
    implementation runs it too."""
    for name, t in (("a", a), ("g", g)):
        if not _client_block_contiguous(t):
            raise ValueError(f"sgd_update kernel needs each client's block of {name} "
                             f"contiguous; {name} has strides {tuple(t.stride())}")


def launch_config(dtype: torch.dtype, broadcast: bool) -> dict:
    """A variant's launch configuration from the built library (card only):
    threads a CTA, the resident CTAs a SM that
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` reports, SMs,
    registers and local bytes a thread, elements a vector, vectors in
    flight a thread."""
    out = (ctypes.c_int * 7)()
    err = LIBRARY.load().sgd_update_config(DTYPES[dtype], int(broadcast), out)
    if err != 0:
        raise RuntimeError(f"sgd_update_config failed: CUDA error {err}")
    keys = ("threads", "ctas_per_sm", "sms", "registers", "local_bytes", "vector",
            "unroll")
    return dict(zip(keys, out))


def sgd_update_cuda(a: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """a, g (K, ...) of one dtype -> (K, ...) contiguous, a - lr * g in fp32
    rounded to the dtype.

    CUDA tensors launch the kernel (and count the launch); CPU tensors take
    the plain version; anything else raises.  a and g are read through
    their client strides (a's 0 when broadcast); each client's block must be
    contiguous, and the kernel raises on anything else rather than copy.
    The output is new storage: it never aliases a or g.
    """
    _check(a, g)
    dev = a.device
    if dev.type == "cpu":
        return sgd_update_ref(a, g, lr)
    if dev.type != "cuda":
        raise ValueError(f"sgd_update runs on cuda or cpu tensors, got {dev}")
    check_launch(a, g)
    out = torch.empty(a.shape, dtype=a.dtype, device=dev)
    if out.numel() == 0:
        return out
    k = a.shape[0]
    err = call_on_device(
        dev.index, LIBRARY.load().sgd_update_launch,
        a.data_ptr(), g.data_ptr(), out.data_ptr(), DTYPES[a.dtype], k, out.numel() // k,
        a.stride(0), g.stride(0), lr, stream_handle(dev.index))
    if err != 0:
        raise RuntimeError(f"sgd_update kernel launch failed: CUDA error {err}")
    sgd_update_cuda.launches += 1
    return out


sgd_update_cuda.launches = 0
