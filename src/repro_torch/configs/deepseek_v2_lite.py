"""DeepSeek-V2-Lite: MLA, one dense layer, then 64-expert top-6 layers with
2 shared experts [arXiv:2405.04434].  A port-only architecture: the
reference's registry has no counterpart, so the registry resolves it by
name (:func:`repro_torch.configs.get_model_config`) without listing it
(:func:`repro_torch.configs.list_archs` stays the reference's list).

Sizes from the published ``config.json``
(https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json);
the equations are in :mod:`repro_torch.models.attention` (MLA and YaRN) and
:mod:`repro_torch.models.moe` (shared experts, gates, the sequence-level
balance loss, the held experts).  ``d_ff`` is the routed experts' width,
as in OLMoE's entry; ``d_ff_dense`` the dense first layer's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, MoEConfig


@dataclass(frozen=True)
class SharedMoEConfig(MoEConfig):
    """An expert layer with shared experts beside the routed ones, gates that
    may stay unrenormalised, a per-sequence balance loss, and a share of the
    routed experts held here (``experts_held`` from ``expert_offset``; 0
    holds all).  ``n_experts`` stays the router's count."""

    n_shared_experts: int = 0
    norm_topk_prob: bool = True
    seq_aux: bool = False
    experts_held: int = 0
    expert_offset: int = 0

    @property
    def d_ff_shared(self) -> int:
        """The shared experts' width: one SwiGLU of ``n_shared_experts`` x
        the expert width, as the published code builds them."""
        return self.n_shared_experts * self.d_ff_expert


@dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """Multi-head latent attention (no low-rank query: ``q = x Wq``) with
    YaRN RoPE, and ``first_k_dense`` dense layers (FFN width ``d_ff_dense``)
    before the expert layers."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_factor: float = 1.0          # YaRN scaling factor
    rope_original_max_pos: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
    first_k_dense: int = 0
    d_ff_dense: int = 0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def mla_params(self) -> int:
        """One MLA block: ``wq``, ``wkv_a``, the latent norm, ``wkv_b``, ``wo``."""
        d, h, r = self.d_model, self.n_heads, self.kv_lora_rank
        return (d * h * self.qk_head_dim + d * (r + self.qk_rope_head_dim) + r
                + r * h * (self.qk_nope_head_dim + self.v_head_dim)
                + h * self.v_head_dim * d)

    def _layer_counts(self, experts: float) -> float:
        d, moe = self.d_model, self.moe
        dense = self.mla_params() + 3 * d * self.d_ff_dense + 2 * d
        expert = 3 * d * moe.d_ff_expert
        moe_layer = (self.mla_params() + d * moe.n_experts + 3 * d * moe.d_ff_shared
                     + experts * expert + 2 * d)
        head = 0 if self.tie_embeddings else self.vocab_size * d
        return (self.vocab_size * d + head + d + self.first_k_dense * dense
                + (self.n_layers - self.first_k_dense) * moe_layer)

    def param_count(self) -> int:
        """Every leaf: embedding, head, final norm, the dense layers (MLA,
        FFN, norms) and the expert layers (MLA, router, shared experts, the
        held routed experts, norms)."""
        return int(self._layer_counts(self.moe.held))

    def active_param_count(self) -> int:
        """Parameters a token passes through here: the routed experts at the
        expected share this layer computes, ``top_k x held / n_experts``."""
        moe = self.moe
        return int(round(self._layer_counts(moe.top_k * moe.held / moe.n_experts)))


CONFIG = MLAConfig(
    name="deepseek-v2-lite",
    family="moe",
    citation="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=192,              # q.k width: 128 without RoPE + 64 with it
    d_ff=1408,                 # per-expert FFN width
    vocab_size=102400,
    activation="silu",
    norm="rmsnorm",
    attention="mla",
    rope_theta=10000.0,
    moe=SharedMoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, load_balance_coef=0.001,
                        router_z_coef=0.0, n_shared_experts=2, norm_topk_prob=False,
                        seq_aux=True),
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    rope_factor=40.0,
    rope_original_max_pos=4096,
    rope_beta_fast=32.0,
    rope_beta_slow=1.0,
    rope_mscale=0.707,
    rope_mscale_all_dim=0.707,
    first_k_dense=1,
    d_ff_dense=10944,
)


def reduced(cfg: MLAConfig) -> MLAConfig:
    """The smoke variant: MLA at small ranks, one dense layer then two
    expert layers, 4 of 8 routed experts held (from expert 2), top 2, 2
    shared experts, lossless capacity; YaRN as published."""
    moe = dataclasses.replace(cfg.moe, n_experts=8, top_k=2, d_ff_expert=32,
                              experts_held=4, expert_offset=2, capacity_factor=4.0)
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=24, d_ff=32, vocab_size=256, moe=moe, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, d_ff_dense=128,
        dtype="float32", remat=False)
