"""Parameter dicts between numpy arrays and the port's tensors.

The JAX reference keeps parameters as dicts of arrays (``w1, b1, w2, b2, w3,
b3`` with ``w`` shaped ``(in, out)``), the same layout as the port, so a
conversion is a leaf-wise copy:

    q = params_from_numpy({k: np.asarray(v) for k, v in jax_q.items()}, "cpu")

Works for the Q-net and for ``MLPTask`` parameters.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device


def params_from_numpy(tree: Mapping[str, Any],
                      device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Array-like leaves (anything ``np.asarray`` takes) -> tensors on
    ``device`` (the card unless ``device="cpu"``), dtype kept."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, copy=True), device=dev)
            for k, v in tree.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Tensors on any device -> host numpy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
