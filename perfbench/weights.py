"""The weights both sides start from, drawn on the device from the seed.

The layout is the port's (nested dicts, the layers stacked on a leading
axis, ``(in, out)`` matrices); the distributions are the published
initialisers the port also uses (products: N(0, 1) cut at +-2 over
sqrt(fan-in); embedding and head: N(0, 0.02^2); norms: ones).  One
generator on the device draws each leaf in one call, in float32, which is
then cast to the leaf's dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

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
    """The model's weights for configuration file ``cfg``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    dt = DTYPES[cfg["dtype"]]
    d, v, n = cfg["d_model"], cfg["vocab_size"], cfg["n_layers"]
    qd, kvd = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)
    layers = {
        "norm1": {"scale": ones(n, d)},
        "norm2": {"scale": ones(n, d)},
        "attn": {"wq": _dense(gen, (n, d, qd), d, dt), "wk": _dense(gen, (n, d, kvd), d, dt),
                 "wv": _dense(gen, (n, d, kvd), d, dt), "wo": _dense(gen, (n, qd, d), qd, dt)},
    }
    moe = cfg.get("moe")
    if moe:
        e, f = moe["n_experts"], moe["d_ff_expert"]
        layers["moe"] = {"router": _dense(gen, (n, d, e), d, torch.float32),
                         "up": _dense(gen, (n, e, d, f), d, dt),
                         "down": _dense(gen, (n, e, f, d), f, dt),
                         "gate": _dense(gen, (n, e, d, f), d, dt)}
    else:
        f = cfg["d_ff"]
        layers["mlp"] = {"up": _dense(gen, (n, d, f), d, dt),
                         "down": _dense(gen, (n, f, d), f, dt),
                         "gate": _dense(gen, (n, d, f), d, dt)}
    return {"embed": _normal(gen, (v, d), 0.02, dt),
            "final_norm": {"scale": ones(d)},
            "layers": layers,
            "lm_head": _normal(gen, (d, v), 0.02, dt)}


def qnet_weights(seed: int, device) -> Dict[str, torch.Tensor]:
    """The FedRank Q-net's cold start: 6 -> 64 -> 64 -> 1, fp32."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    h = QNET_HIDDEN
    zeros = lambda s: torch.zeros(s, dtype=torch.float32, device=device)
    return {"w1": _dense(gen, (QNET_IN, h), QNET_IN, torch.float32), "b1": zeros(h),
            "w2": _dense(gen, (h, h), h, torch.float32), "b2": zeros(h),
            "w3": _dense(gen, (h, 1), h, torch.float32), "b3": zeros(1)}
