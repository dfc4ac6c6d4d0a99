"""Yi-6B: llama-architecture dense decoder with GQA [arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    citation="arXiv:2403.04652",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64000,
    activation="silu",
    norm="rmsnorm",
    attention="full",
    rope_theta=5000000.0,
)
