"""Hymba-1.5B: hybrid-head model — parallel attention + Mamba heads in every
layer, sliding-window attention on most layers [arXiv:2411.13676]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    citation="arXiv:2411.13676",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    activation="silu",
    norm="rmsnorm",
    attention="hybrid",       # parallel attn + SSM heads; attn part is SWA
    window=1024,
    ssm=SSMConfig(state_size=16, ssm_kind="mamba"),
)
