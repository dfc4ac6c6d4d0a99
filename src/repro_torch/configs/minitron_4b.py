"""Minitron-4B: width-pruned Nemotron-4 15B (squared-ReLU MLP, GQA)
[arXiv:2407.14679]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    citation="arXiv:2407.14679",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    activation="relu2",        # nemotron squared ReLU
    norm="layernorm",
    attention="full",
)
