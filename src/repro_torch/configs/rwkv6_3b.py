"""RWKV6-3B ("Finch"): attention-free RNN with data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    citation="arXiv:2404.05892",
    n_layers=32,
    d_model=2560,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    head_dim=0,
    d_ff=8960,
    vocab_size=65536,
    activation="relu2",        # rwkv channel-mix uses squared relu
    norm="layernorm",
    attention="none",
    use_rope=False,
    ssm=SSMConfig(state_size=64, ssm_kind="rwkv6"),  # head dim 64 -> 40 wkv heads
)
