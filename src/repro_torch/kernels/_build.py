"""Build and load the port's CUDA kernels: ``nvcc`` at first use, ``ctypes``.

Each source under ``src/repro_torch/csrc/`` is one :class:`CudaLibrary`: a
shared library with a plain C interface, compiled for ``sm_90a`` into
``build/kernels/`` at the repository root and named by a hash of the source
and the flags, so an edited source rebuilds.  Nothing is built when a module
is imported; :meth:`CudaLibrary.load` builds on the first launch.
Independent libraries may build at the same time (one ``nvcc`` each, e.g.
from a thread pool): every build writes a temporary file and renames it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Callable, Optional

import torch

_PKG = Path(__file__).resolve().parents[1]                  # src/repro_torch
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built from source")


class CudaLibrary:
    """``csrc/<name>.cu`` built into ``build/kernels/lib<name>-<hash>.so``.

    ``bind`` sets ``argtypes``/``restype`` on the loaded library's entry
    points.  ``build_log`` keeps ``nvcc``'s output of the last build here
    (``-Xptxas -v``: registers, shared memory and spills per kernel).
    """

    def __init__(self, name: str, bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.build_log = ""
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()
                                + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def build(self) -> Path:
        """Compile the library if it is not built yet; returns its path."""
        out = self.library_path()
        if out.exists():
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n{self.build_log}")
        os.replace(tmp, out)               # atomic: readers never see a partial file
        return out

    def load(self) -> ctypes.CDLL:
        lib = self._lib                    # set once, never reset: no lock needed
        if lib is not None:
            return lib
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib


def stream_handle(index: int) -> int:
    """The raw handle of device ``index``'s current stream, read without
    building a ``torch.cuda.Stream`` (what a launch passes to C)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def call_on_device(index: int, fn, *args):
    """``fn(*args)`` with device ``index`` current, switching devices only
    when another one is."""
    if torch.cuda.current_device() == index:
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)
