"""InternVL2-76B language backbone (Hermes-2-Theta-Llama-3-70B) [arXiv:2404.16821].

VLM: the InternViT-6B vision encoder + MLP projector is a STUB — ``input_specs``
provides precomputed patch embeddings (n_tokens x d_model) per image.
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    citation="arXiv:2404.16821",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    activation="silu",
    norm="rmsnorm",
    attention="full",
    rope_theta=500000.0,
    frontend=FrontendConfig(kind="vision", n_tokens=256, embed_dim=8192),
)
