"""The benchmark's own operation and byte counts, and the table of peaks.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense,
no sparsity).  A round's model FLOPs count the useful products only: 6 x
the active matrix parameters per trained token (forward and backward), 2 x
per evaluated token, and the causal attention products (2 x S(S+1) x Dh x
heads per sequence and layer forward, 3 x that trained); padding rows and
remat's recomputed forward are left out.
"""
from __future__ import annotations

H100_BF16_FLOPS = 989e12     # tensor-core dense bf16
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3


def matmul_params(cfg: dict) -> int:
    """Matrix parameters a token passes through: attention, the dense FFN
    or the router and its top-k experts, and the output head (the
    embedding is a lookup)."""
    d = cfg["d_model"]
    qd, kvd = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    per_layer = 2 * d * qd + 2 * d * kvd
    moe = cfg.get("moe")
    if moe:
        per_layer += d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
    else:
        per_layer += 3 * d * cfg["d_ff"]
    return cfg["n_layers"] * per_layer + d * cfg["vocab_size"]


def attention_flops(cfg: dict, seq: int) -> float:
    """Forward causal attention products of one sequence over all layers."""
    return 2.0 * seq * (seq + 1) * cfg["head_dim"] * cfg["n_heads"] * cfg["n_layers"]


def round_flops(cfg: dict, seq: int, trained_seqs: int, eval_seqs: int) -> float:
    """Model FLOPs of one round that trains ``trained_seqs`` sequences (one
    forward and backward each, summed over clients and steps) and evaluates
    ``eval_seqs``."""
    p = matmul_params(cfg)
    att = attention_flops(cfg, seq)
    return (trained_seqs * (6.0 * p * seq + 3.0 * att)
            + eval_seqs * (2.0 * p * seq + att))


def topk_bound_ms(n: int, f: int, h: int, k: int) -> float:
    """Least time of one ``select_topk`` call: 2N(FH + H^2 + H) fp32 FLOPs
    on the CUDA cores, or its bytes (inputs read once, outputs written
    once) over HBM bandwidth, the larger."""
    flops = 2.0 * n * (f * h + h * h + h)
    nbytes = 4.0 * (n * f + 2 * n + f * h + h * h + 3 * h + 1) + 8.0 * k
    return 1e3 * max(flops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S)
