"""The weights both sides start from, drawn on the device from the seed.

The layout is the port's (nested dicts, the layers stacked on a leading
axis, ``(in, out)`` matrices), each family's own; the distributions are the published
initialisers the port also uses (products: N(0, 1) cut at +-2 over
sqrt(fan-in); embedding and head: N(0, 0.02^2); norms: ones).  One
generator on the device draws each leaf in one call, in float32, which is
then cast to the leaf's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from perfbench import families

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
QNET_HIDDEN = 64
QNET_IN = 6


def _dense(gen, shape: Tuple[int, ...], fan_in: int, dtype) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(1.0 / math.sqrt(fan_in)).to(dtype)


def _normal(gen, shape: Tuple[int, ...], std: float, dtype) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return t.normal_(0.0, std, generator=gen).to(dtype)


def model_weights(cfg: dict, seed: int, device) -> Dict:
    """The model's weights for configuration ``cfg``, in its family's layout
    and draw order (``perfbench/families/``), from one generator."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return families.of(cfg).weights(cfg, gen, device)


def qnet_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """The FedRank Q-net's cold start: 6 -> 64 -> 64 -> 1, fp32."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    h = QNET_HIDDEN
    zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"w1": _dense(gen, (QNET_IN, h), QNET_IN, torch.float32), "b1": zeros(h),
            "w2": _dense(gen, (h, h), h, torch.float32), "b2": zeros(h),
            "w3": _dense(gen, (h, 1), h, torch.float32), "b3": zeros(1)}
