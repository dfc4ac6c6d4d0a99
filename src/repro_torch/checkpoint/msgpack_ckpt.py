"""Msgpack + zstd checkpoints of parameter trees, in the reference's format
byte for byte.

Arrays are stored as ``(dtype, shape, raw bytes)``; dicts as msgpack maps
with their keys sorted at every level (the reference's ``jax.tree.map``
sorts them), lists as lists, tuples as ``{"__tuple__": [...], "cls"}``.
Leaves are what ``np.asarray`` makes of them: tensors on any device, numpy
arrays, Python scalars (0-d arrays) and strings.  Dtype names are numpy's;
bfloat16 (and float8) tensors are stored from their bits, so no
``ml_dtypes`` is needed.  Files are zstd-compressed at level 3 when the
``zstandard`` module imports, zlib at level 3 otherwise, and written
atomically through ``<path>.tmp``.  Either package reads the other's
files.
"""
from __future__ import annotations

import os
import re
import zlib
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from repro_torch.convert import _BITCAST

try:
    import zstandard
except ImportError:          # fall back to the standard library's zlib
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_ARR_KEY = "__ndarray__"
_TUPLE_KEY = "__tuple__"

# torch dtypes stored from their bits -> (numpy dtype name, integer view)
_BITS = {dt: (name, torch.int16 if raw is np.int16 else torch.uint8)
         for name, (raw, dt) in _BITCAST.items()}


def _array(dtype: str, shape, data: bytes) -> dict:
    return {_ARR_KEY: True, "dtype": dtype, "shape": list(shape), "data": data}


def _encode(obj: Any) -> Any:
    """The reference's ``_encode`` of ``jax.tree.map(np.asarray, obj)``."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu().contiguous()
        if t.dtype in _BITS:
            name, raw = _BITS[t.dtype]
            return _array(name, t.shape, t.view(raw).numpy().tobytes())
        arr = t.numpy()
        return _array(str(arr.dtype), arr.shape, arr.tobytes())
    if isinstance(obj, dict):
        return {str(k): _encode(obj[k]) for k in sorted(obj)}
    if isinstance(obj, tuple):
        return {_TUPLE_KEY: [_encode(v) for v in obj], "cls": type(obj).__name__}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if obj is None:
        return None
    arr = np.asarray(obj)
    if arr.dtype == object:
        raise TypeError(f"cannot checkpoint object of type {type(obj)}")
    return _array(str(arr.dtype), arr.shape, arr.tobytes())


def _decode(obj: Any) -> Any:
    if isinstance(obj, dict):
        if obj.get(_ARR_KEY):
            name, shape = obj["dtype"], obj["shape"]
            if name in _BITCAST:
                raw, dt = _BITCAST[name]
                return torch.from_numpy(
                    np.frombuffer(obj["data"], dtype=raw).reshape(shape).copy()).view(dt)
            arr = np.frombuffer(obj["data"], dtype=np.dtype(name)).reshape(shape).copy()
            # numbers become tensors; strings stay numpy arrays, as the
            # reference loads them
            return torch.from_numpy(arr) if arr.dtype.kind in "biuf" else arr
        if _TUPLE_KEY in obj:
            return tuple(_decode(v) for v in obj[_TUPLE_KEY])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def save_pytree(tree: Any, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = msgpack.packb(_encode(tree), use_bin_type=True)
    if zstandard is not None:
        comp = zstandard.ZstdCompressor(level=3).compress(payload)
    else:
        comp = zlib.compress(payload, level=3)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(comp)
    os.replace(tmp, path)


def load_pytree(path: str) -> Any:
    """The saved tree, numeric arrays as CPU tensors (bfloat16 as
    ``torch.bfloat16``), tuples as tuples."""
    with open(path, "rb") as f:
        comp = f.read()
    if comp[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(f"{path} is zstd-compressed but the zstandard "
                               "module is not installed")
        payload = zstandard.ZstdDecompressor().decompress(comp)
    else:
        payload = zlib.decompress(comp)
    return _decode(msgpack.unpackb(payload, raw=False))


def latest_checkpoint(ckpt_dir: str, prefix: str = "step_") -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    pat = re.compile(re.escape(prefix) + r"(\d+)\.ckpt$")
    for name in os.listdir(ckpt_dir):
        m = pat.match(name)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(ckpt_dir, name)
    return best
