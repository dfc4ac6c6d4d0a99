"""H2O-Danube-3-4B: llama+mistral mix with sliding-window attention
[arXiv:2401.16818]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    citation="arXiv:2401.16818",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    activation="silu",
    norm="rmsnorm",
    attention="swa",
    window=4096,               # mistral-style sliding window -> long_500k eligible
    tie_embeddings=True,
)
