"""Config system of the port: the reference's ``repro.configs.base``, copied.

Every assigned architecture is expressed as a :class:`ModelConfig`; the four
assigned input shapes as :class:`ShapeConfig`.  Configs are frozen dataclasses
so they can be hashed and compared in tests.  They are data, kept field for
field equal to the reference's (``tests/test_torch_lm.py`` checks it), so
every architecture name resolves in the port, also those whose families the
port's model does not run yet.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts FFN configuration."""

    n_experts: int
    top_k: int
    d_ff_expert: int
    # router
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    router_z_coef: float = 1e-3
    # dispatch plumbing: "sort" (deployable) | "dense" (GShard baseline)
    dispatch: str = "sort"
    n_groups: int = 1             # launch layer aligns this with the data axis

    # Settings that only a port-only subclass makes fields
    # (configs/deepseek_v2_lite.py ``SharedMoEConfig``): class attributes
    # here, not fields, so this class stays field for field the reference's.
    n_shared_experts = 0          # shared SwiGLU experts beside the routed ones
    norm_topk_prob = True         # renormalise the top-k gates to sum to 1
    seq_aux = False               # balance loss per sequence, not per call
    experts_held = 0              # routed experts this layer holds (0: all) ...
    expert_offset = 0             # ... from this one on

    @property
    def held(self) -> int:
        """How many routed experts this layer holds and computes."""
        return self.experts_held or self.n_experts


@dataclass(frozen=True)
class SSMConfig:
    """State-space / linear-recurrence configuration (RWKV6 & Mamba-style)."""

    state_size: int = 16          # per-head recurrent state width (hymba) / rwkv head dim
    ssm_kind: str = "rwkv6"       # "rwkv6" | "mamba"
    n_ssm_heads: int = 0          # 0 -> derived (d_model // state-derived head dim)
    dt_rank: int = 0              # mamba delta-projection rank (0 -> d_model//16)
    conv_width: int = 4           # mamba local conv width
    scan_unroll: int = 1          # time-scan unroll factor (perf lever: fewer
    #                               loop iterations -> fewer output-stack copies)


@dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend: provides precomputed embeddings of the right
    shape via ``input_specs`` (the one sanctioned stub)."""

    kind: str                     # "vision" | "audio"
    n_tokens: int                 # patch / frame tokens prepended per example
    embed_dim: int                # frontend output dim (== d_model after projector)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """One unified config covering all 6 assigned architecture families."""

    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    citation: str

    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attn-free)
    n_kv_heads: int               # GQA kv heads (== n_heads -> MHA)
    head_dim: int                 # explicit: gemma uses 256 != d_model//n_heads
    d_ff: int
    vocab_size: int

    activation: str = "silu"      # silu | geglu | gelu | relu2
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    attention: str = "full"       # full | swa | none (attn-free) | hybrid
    window: Optional[int] = None  # sliding-window size when attention == "swa"/"hybrid"
    rope_theta: float = 10000.0
    use_rope: bool = True         # whisper uses learned positions instead
    tie_embeddings: bool = False
    logit_softcap: float = 0.0    # gemma-style final-logit soft cap (0 = off)

    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None

    # encoder-decoder (whisper): n_enc_layers encoder layers w/ full bidir attn
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 0              # encoder sequence length (audio frames)

    dtype: str = "bfloat16"
    remat: bool = True            # activation checkpointing around each layer
    kv_cache_dtype: str = ""      # "" -> dtype; e.g. "float8_e4m3fn" halves
    #                               decode cache memory (beyond-paper serving)

    # Leading dense layers before the expert stack: only a port-only subclass
    # sets it (configs/deepseek_v2_lite.py); a class attribute, not a field.
    first_k_dense = 0

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def group_size(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        embed = v * d
        head = 0 if self.tie_embeddings else v * d
        per_layer = 0
        if self.attention in ("full", "swa", "hybrid") and self.n_heads > 0:
            per_layer += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.ssm is not None:
            if self.ssm.ssm_kind == "rwkv6":
                # r,k,v,g,o projections + decay/mix params
                per_layer += 5 * d * d + 6 * d
            else:  # mamba head bank (hymba)
                inner = d
                dt_rank = self.ssm.dt_rank or max(1, d // 16)
                per_layer += (
                    2 * d * inner                       # in_proj (x, z)
                    + inner * self.ssm.conv_width       # conv
                    + inner * (dt_rank + 2 * self.ssm.state_size)
                    + dt_rank * inner                   # dt proj
                    + inner * self.ssm.state_size       # A
                    + inner                             # D
                    + inner * d                         # out proj
                )
        # FFN
        n_ff_mats = 3 if self.activation in ("silu", "geglu") else 2
        if self.moe is not None:
            per_layer += d * self.moe.n_experts  # router
            per_layer += self.moe.n_experts * n_ff_mats * d * self.moe.d_ff_expert
        else:
            per_layer += n_ff_mats * d * f
        per_layer += 2 * d  # two norms
        total = embed + head + self.n_layers * per_layer
        if self.enc_dec:
            # encoder layers: self-attn + ffn; decoder layers add cross-attn
            enc_layer = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            enc_layer += n_ff_mats * d * f + 2 * d
            cross = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d + d
            total += self.n_enc_layers * enc_layer + self.n_layers * cross
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        n_ff_mats = 3 if self.activation in ("silu", "geglu") else 2
        expert_p = n_ff_mats * d * self.moe.d_ff_expert
        dense_total = self.param_count() - self.n_layers * self.moe.n_experts * expert_p
        return dense_total + self.n_layers * self.moe.top_k * expert_p

    def supports_long_context(self) -> bool:
        """True if decode with a 500k context is sub-quadratic for this arch."""
        if self.attention == "none":
            return True                      # SSM: O(1) state
        if self.attention in ("swa", "hybrid") and self.window:
            return True                      # bounded KV window
        return False

    def has_decode(self) -> bool:
        return True  # all assigned archs have a decoder (whisper is enc-dec)


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in INPUT_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown input shape {name!r}; have {[s.name for s in INPUT_SHAPES]}")


# ---------------------------------------------------------------------------
# Reduced (smoke-test) variants
# ---------------------------------------------------------------------------


def reduced(cfg: ModelConfig, *, d_model: int = 128, n_layers: int = 2) -> ModelConfig:
    """A tiny same-family variant: 2 layers, d_model<=512, <=4 experts.

    Keeps the family topology (GQA ratio, MoE routing, SSM kind, enc-dec,
    frontend) so smoke tests exercise the same code paths as the full config.
    """
    assert d_model <= 512
    n_heads = max(2, min(cfg.n_heads, 4)) if cfg.n_heads else 0
    n_kv = max(1, n_heads // cfg.group_size) if n_heads else 0
    head_dim = d_model // max(n_heads, 1) if n_heads else 0
    moe = None
    if cfg.moe is not None:
        n_exp = min(4, cfg.moe.n_experts)
        top_k = min(2, cfg.moe.top_k)
        moe = dataclasses.replace(
            cfg.moe,
            n_experts=n_exp,
            top_k=top_k,
            d_ff_expert=d_model * 2,
            # lossless capacity so smoke tests are drop-free and deterministic
            capacity_factor=float(n_exp) / top_k,
        )
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(cfg.ssm, state_size=min(cfg.ssm.state_size, 16), n_ssm_heads=0)
    frontend = None
    if cfg.frontend is not None:
        frontend = dataclasses.replace(cfg.frontend, n_tokens=8, embed_dim=d_model)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        n_enc_layers=min(cfg.n_enc_layers, n_layers),
        enc_seq=min(cfg.enc_seq, 16) if cfg.enc_dec else 0,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        d_ff=d_model * 4,
        vocab_size=256,
        window=min(cfg.window, 64) if cfg.window else None,
        moe=moe,
        ssm=ssm,
        frontend=frontend,
        dtype="float32",
        remat=False,
    )
