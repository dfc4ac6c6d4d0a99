"""The benchmark's own operation and byte counts, and the table of peaks.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit (dense,
no sparsity).  A round's model FLOPs count the useful products only: 6 x
the active matrix parameters per trained token (forward and backward), 2 x
per evaluated token, and the attention products (a sequence's forward, 3 x
that trained); padding rows and remat's recomputed forward are left out.
The family of the configuration (``perfbench/families/``) counts the
parameters and the attention products.
"""
from __future__ import annotations

from perfbench import families

H100_BF16_FLOPS = 989e12     # tensor-core dense bf16
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3


def matmul_params(cfg: dict) -> int:
    """Matrix parameters a token passes through, by ``cfg``'s family."""
    return families.of(cfg).matmul_params(cfg)


def attention_flops(cfg: dict, seq: int) -> float:
    """Forward attention products of one sequence over all layers, by
    ``cfg``'s family."""
    return families.of(cfg).attention_flops(cfg, seq)


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
