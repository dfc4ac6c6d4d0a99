"""Phi-3.5-MoE: 16-expert top-2 MoE, 6.6B active / 42B total
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    citation="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,                 # per-expert FFN width
    vocab_size=32064,
    activation="silu",
    norm="layernorm",
    attention="full",
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400),
)
