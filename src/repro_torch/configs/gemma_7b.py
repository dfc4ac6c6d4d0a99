"""Gemma-7B: dense decoder, GeGLU activation, head_dim=256 (MQA on the 2B
variant; 7B is MHA with 16 kv heads) [arXiv:2403.08295]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    citation="arXiv:2403.08295",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,              # != d_model // n_heads — wide heads
    d_ff=24576,
    vocab_size=256000,
    activation="geglu",
    norm="rmsnorm",
    attention="full",
    tie_embeddings=True,
)
