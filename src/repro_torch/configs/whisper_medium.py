"""Whisper-medium transformer backbone [arXiv:2212.04356].

Audio: enc-dec. The mel-spectrogram + conv feature extractor is a STUB —
``input_specs`` provides precomputed frame embeddings (1500 x 1024).
"""
from repro_torch.configs.base import FrontendConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    citation="arXiv:2212.04356",
    n_layers=24,            # decoder layers
    n_enc_layers=24,        # encoder layers
    enc_dec=True,
    enc_seq=1500,           # 30 s of audio at 50 frames/s after the conv stack
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,          # MHA
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    attention="full",
    use_rope=False,         # whisper uses learned/sinusoidal positions
    tie_embeddings=True,
    frontend=FrontendConfig(kind="audio", n_tokens=1500, embed_dim=1024),
)
