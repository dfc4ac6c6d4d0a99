"""Parameter trees and decode states between numpy arrays and the port's
tensors.

The JAX reference keeps parameters as (nested) dicts of arrays, the same
layout as the port: the Q-net and ``MLPTask`` as flat dicts (``w1, b1, ...``
with ``w`` shaped ``(in, out)``), the LM as ``{"embed", "final_norm",
"layers": {...}, "lm_head"}`` with every ``layers`` leaf stacked over L
(and the zoo's other leaves in place: an MoE layer's ``moe`` experts,
whisper's ``encoder`` and ``cross_attn``, a ``frontend_proj``).  A
conversion is a leaf-wise copy that keeps each leaf's dtype:

    q = params_from_numpy({k: np.asarray(v) for k, v in jax_q.items()}, "cpu")
    lm = params_from_numpy(jax.tree.map(np.asarray, jax_lm), "cpu")

bfloat16 and float8 arrays (numpy's ``ml_dtypes`` types, as ``np.asarray``
of a JAX array gives them) are carried bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device

# numpy extension dtypes (ml_dtypes) by name -> (a numpy integer type of the
# same width, the torch dtype of the same bits)
_BITCAST = {"bfloat16": (np.int16, torch.bfloat16),
            "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
            "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def to_tensor(a: Any, device: torch.device) -> torch.Tensor:
    """One array-like -> a tensor on ``device`` with the same dtype and bits."""
    arr = np.array(a, copy=True)
    if arr.dtype.name in _BITCAST:
        raw, dt = _BITCAST[arr.dtype.name]
        return torch.as_tensor(arr.view(raw)).view(dt).to(device)
    return torch.as_tensor(arr, device=device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor -> a host numpy array of the same dtype (bfloat16 and
    float8 as ``ml_dtypes`` arrays, which needs that package)."""
    t = t.detach().cpu()
    for name, (raw, dt) in _BITCAST.items():
        if t.dtype == dt:
            import ml_dtypes

            bits = t.view(torch.int16 if raw is np.int16 else torch.uint8).numpy()
            return bits.view(getattr(ml_dtypes, name))
    return t.numpy()


def params_from_numpy(tree: Mapping[str, Any],
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Array-like leaves of a (nested) dict -> tensors on ``device`` (the
    card unless ``device="cpu"``), dtype kept."""
    dev = resolve_device(device)
    return {k: (params_from_numpy(v, dev) if isinstance(v, Mapping) else to_tensor(v, dev))
            for k, v in tree.items()}


def params_to_numpy(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Tensors of a (nested) dict, on any device -> host numpy arrays."""
    return {k: (params_to_numpy(v) if isinstance(v, Mapping) else to_numpy(v))
            for k, v in params.items()}


def decode_state_from_numpy(state: Any, device: DeviceLike = None):
    """A reference ``DecodeState`` whose leaves are numpy arrays
    (``jax.tree.map(np.asarray, state)``) -> the port's
    :class:`~repro_torch.models.transformer.DecodeState` on ``device``, so a
    test can run the port's decode from the reference's prefill.  Its
    layers may hold ``"kv"`` (ring K/V caches), ``"mamba"`` (Hymba's Mamba
    state) and ``"rwkv"`` (RWKV6's state), each a named tuple of stacked
    arrays with the port's field order; whisper's ``cross_kv`` is a tuple
    of two stacked arrays (k, v), each (L, B, enc_seq, KV, Dh)."""
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import MambaState, RWKVState
    from repro_torch.models.transformer import DecodeState

    dev = resolve_device(device)
    kinds = {"kv": KVCache, "mamba": MambaState, "rwkv": RWKVState}
    layers = {}
    for name, leaves in state.layers.items():
        if name not in kinds:
            raise NotImplementedError(f"decode-state leaf {name!r} is not ported; "
                                      f"have {sorted(kinds)}")
        if tuple(leaves._fields) != kinds[name]._fields:
            raise ValueError(f"{name}: fields {leaves._fields}, expected "
                             f"{kinds[name]._fields}")
        layers[name] = kinds[name](*(to_tensor(a, dev) for a in leaves))
    cross_kv = None
    if state.cross_kv is not None:
        cross_kv = tuple(to_tensor(a, dev) for a in state.cross_kv)
        if len(cross_kv) != 2:
            raise ValueError(f"cross_kv holds {len(cross_kv)} arrays, expected (k, v)")
    return DecodeState(layers, to_tensor(state.step, dev), cross_kv)
