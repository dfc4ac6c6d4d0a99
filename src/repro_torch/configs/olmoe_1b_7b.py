"""OLMoE-1B-7B: 64-expert top-8 MoE, 1B active / 7B total [arXiv:2409.02060]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    citation="arXiv:2409.02060",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,                 # per-expert FFN width
    vocab_size=50304,
    activation="silu",
    norm="rmsnorm",
    attention="full",
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
)
