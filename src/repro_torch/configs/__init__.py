"""Architecture / shape registry.

``get_model_config("yi-6b")`` returns the full assigned config;
``get_model_config("yi-6b", smoke=True)`` returns the reduced same-family
variant used by CPU smoke tests.  The port's own copy of the reference's
registry (``repro.configs``), with the same names and aliases, which
:func:`list_archs` lists; beside it the port-only architectures, which
:func:`port_archs` lists and ``get_model_config`` resolves as well.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (
    INPUT_SHAPES,
    FrontendConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    get_shape,
    reduced,
)

from repro_torch.configs import (  # noqa: E402
    deepseek_v2_lite,
    gemma_7b,
    h2o_danube_3_4b,
    hymba_1_5b,
    internvl2_76b,
    minitron_4b,
    olmoe_1b_7b,
    phi35_moe,
    rwkv6_3b,
    whisper_medium,
    yi_6b,
)

_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        internvl2_76b,
        whisper_medium,
        yi_6b,
        hymba_1_5b,
        rwkv6_3b,
        gemma_7b,
        minitron_4b,
        h2o_danube_3_4b,
        olmoe_1b_7b,
        phi35_moe,
    )
}

# short aliases
_ALIASES = {
    "internvl2-76b": "internvl2-76b",
    "whisper-medium": "whisper-medium",
    "yi-6b": "yi-6b",
    "hymba-1.5b": "hymba-1.5b",
    "rwkv6-3b": "rwkv6-3b",
    "gemma-7b": "gemma-7b",
    "minitron-4b": "minitron-4b",
    "h2o-danube-3-4b": "h2o-danube-3-4b",
    "olmoe-1b-7b": "olmoe-1b-7b",
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "phi3.5-moe-42b-a6.6b": "phi3.5-moe-42b-a6.6b",
}


# the port's own architectures (no reference counterpart), each with its
# smoke variant
_PORT_ONLY = {m.CONFIG.name: m for m in (deepseek_v2_lite,)}


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def port_archs() -> List[str]:
    """The port-only architectures, which :func:`list_archs` leaves out."""
    return sorted(_PORT_ONLY)


def get_model_config(name: str, *, smoke: bool = False) -> ModelConfig:
    key = _ALIASES.get(name, name)
    if key in _PORT_ONLY:
        cfg = _PORT_ONLY[key].CONFIG
        return _PORT_ONLY[key].reduced(cfg) if smoke else cfg
    if key not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; have {list_archs() + port_archs()}")
    cfg = _REGISTRY[key]
    return reduced(cfg) if smoke else cfg


__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "FrontendConfig",
    "ShapeConfig",
    "INPUT_SHAPES",
    "get_shape",
    "get_model_config",
    "list_archs",
    "port_archs",
    "reduced",
]
