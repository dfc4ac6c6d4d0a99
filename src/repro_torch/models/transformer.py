"""The LM of the reference's model zoo, for the attention families.

One parameterized decoder built from GQA attention (full or sliding-window)
and a (Ge)GLU / relu2 FFN: the ``dense`` family of ``repro.models.transformer``
(yi-6b, gemma-7b, minitron-4b, h2o-danube-3-4b).  Other families are
refused where a model is built or run (:func:`init_params`, :func:`forward`,
:func:`prefill`, :func:`init_decode_state`), naming the slice of the port
that brings them: mixture-of-experts layers, the SSM and hybrid families
(rwkv6, hymba), whisper's encoder-decoder and internvl2's frontend.

Parameters are the reference's pytree as nested dicts of tensors:
``{"embed", "final_norm", "layers": {...}, "lm_head"}``, every ``layers``
leaf stacked over a leading ``L`` axis.  The layer loop is a Python loop
over ``L`` that indexes those leaves (views, no copies) in place of
``lax.scan``; ``cfg.remat`` (a training option) has no effect on these
inference paths.  The decode state's caches are stacked the same way and
updated in place by :func:`decode_step` (the reference returns new arrays).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_init,
    init_mlp,
    init_norm,
    softmax_xent,
)

Params = Dict[str, Any]

SSM_SLICE = ("the SSM slice (Hymba and RWKV6, models/ssm.py, with the mamba "
             "and rwkv6 kernels)")
MOE_SLICE = ("the MoE / encoder-decoder / frontend slice (models/moe.py, "
             "whisper's encoder and cross-attention, internvl2's frontend)")


class DecodeState(NamedTuple):
    layers: Any                      # {"kv": KVCache of (L, B, ...) tensors}
    step: torch.Tensor               # (B,) int32: tokens processed per sequence
    cross_kv: Optional[Any] = None   # whisper: stacked (k, v) from encoder


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the slice of the port that brings
    ``cfg``'s family, unless it is an attention family the port runs."""
    if cfg.attention == "none":
        raise NotImplementedError(f"{cfg.name}: RWKV6 layers are not ported yet; "
                                  f"they come with {SSM_SLICE}")
    if cfg.attention == "hybrid":
        raise NotImplementedError(f"{cfg.name}: hybrid attention + Mamba layers are "
                                  f"not ported yet; they come with {SSM_SLICE}")
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts layers are not "
                                  f"ported yet; they come with {MOE_SLICE}")
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder is not ported "
                                  f"yet; it comes with {MOE_SLICE}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend.kind} frontend is "
                                  f"not ported yet; it comes with {MOE_SLICE}")
    if cfg.attention not in ("full", "swa"):
        raise ValueError(f"{cfg.name}: unknown attention kind {cfg.attention!r}")


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the config's dtype names)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views of the stacked leaves."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in layers.items()}


# ===========================================================================
# Init
# ===========================================================================


def init_params(seed: int, cfg: ModelConfig, device: DeviceLike = None) -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on the
    target device (the card unless ``device="cpu"``), drawn there.  The
    reference's distributions; other numbers than its ``jax.random``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    lead = (cfg.n_layers,)
    layers: Params = {
        "norm1": init_norm(cfg.norm, cfg.d_model, torch.float32, dev, lead),
        "norm2": init_norm(cfg.norm, cfg.d_model, torch.float32, dev, lead),
        "attn": attn.init_attention(gen, cfg, dtype, lead),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype, lead),
    }
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.norm, cfg.d_model, torch.float32, dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype).T.contiguous()
    return p


# ===========================================================================
# Forward (training / prefill logits)
# ===========================================================================


def _window(cfg: ModelConfig) -> Optional[int]:
    return cfg.window if cfg.attention in ("swa", "hybrid") else None


def _seq_layer(cfg: ModelConfig, impl: str, x: torch.Tensor, lp: Params
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One layer over a full sequence: (x, (k, v))."""
    h = apply_norm(cfg.norm, lp["norm1"], x)
    a_out, kv = attn.attention_prefill(lp["attn"], h, cfg, causal=True,
                                       window=_window(cfg), impl=impl)
    x = x + a_out
    h = apply_norm(cfg.norm, lp["norm2"], x)
    return x + apply_mlp(lp["mlp"], h, cfg.activation), kv


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, d).  ``frontend_embeds`` keeps the reference's
    signature; the VLM frontend comes with its slice, so it is unused here.
    Every supported family uses RoPE, so no position table is added (the
    reference adds whisper's sinusoids here)."""
    return params["embed"][tokens.long()]


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            impl: str = "naive") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. tokens: (B, S). Returns (logits, aux_loss);
    ``aux`` is 0 for the attention families (MoE adds its router losses)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens, frontend_embeds)
    for i in range(cfg.n_layers):
        x, _ = _seq_layer(cfg, impl, x, layer_params(params["layers"], i))
    return _logits(params, cfg, x), torch.zeros((), dtype=torch.float32, device=x.device)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            impl: str = "naive") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss. batch: tokens (B,S), labels (B,S), optional
    loss_mask."""
    logits, aux = forward(params, cfg, batch["tokens"], batch.get("frontend_embeds"),
                          impl=impl)
    xent = softmax_xent(logits, batch["labels"], batch.get("loss_mask"))
    return xent + aux, {"xent": xent, "aux": aux}


# ===========================================================================
# Decode path
# ===========================================================================


def kv_cache_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.kv_cache_dtype or cfg.dtype)


def _cache_cap(cfg: ModelConfig, max_len: int) -> int:
    w = _window(cfg)
    return min(max_len, w) if w else max_len


def init_decode_state(params: Params, cfg: ModelConfig, batch: int,
                      max_len: int) -> DecodeState:
    """Allocate per-layer ring caches (stacked over L) on the params' device."""
    check_supported(cfg)
    dev = params["embed"].device
    cap = _cache_cap(cfg, max_len)
    shape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    dt = kv_cache_dtype(cfg)
    kv = attn.KVCache(torch.zeros(shape, dtype=dt, device=dev),
                      torch.zeros(shape, dtype=dt, device=dev),
                      torch.zeros((cfg.n_layers, batch), dtype=torch.int32, device=dev))
    return DecodeState({"kv": kv}, torch.zeros((batch,), dtype=torch.int32, device=dev))


def _decode_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params,
                  cache: Dict[str, attn.KVCache]) -> Tuple[torch.Tensor, Dict]:
    """One-token layer step. x: (B,1,d).  Writes the layer's cache in place."""
    h = apply_norm(cfg.norm, lp["norm1"], x)
    a_out, kv2 = attn.attention_decode(lp["attn"], h, cache["kv"], cfg, window=_window(cfg))
    x = x + a_out
    h = apply_norm(cfg.norm, lp["norm2"], x)
    return x + apply_mlp(lp["mlp"], h, cfg.activation), {"kv": kv2}


def _kv_into_ring(k: torch.Tensor, v: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor) -> attn.KVCache:
    """Pack prefilled K/V (B,S,KV,Dh) into the zeroed ring buffers ``ck``/
    ``cv`` (B,C,KV,Dh) (one layer's slice of the stacked cache), in their
    dtype; past the capacity C only the last C positions are kept, each in
    its ring slot."""
    b, s = k.shape[:2]
    cap = ck.shape[1]
    if s <= cap:
        ck[:, :s] = k.to(ck.dtype)
        cv[:, :s] = v.to(cv.dtype)
    else:
        slots = torch.arange(s - cap, s, device=k.device) % cap   # unique slots
        ck[:, slots] = k[:, -cap:].to(ck.dtype)
        cv[:, slots] = v[:, -cap:].to(cv.dtype)
    return attn.KVCache(ck, cv, torch.full((b,), s, dtype=torch.int32, device=k.device))


def prefill(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None,
            impl: str = "naive",
            last_only: bool = False) -> Tuple[torch.Tensor, DecodeState]:
    """Run the full prompt, returning (logits, primed DecodeState).
    ``last_only`` computes logits for the final position only (serving path —
    avoids materializing the (B, S, V) tensor).  ``impl`` picks the prefill
    attention (``"naive"``, the reference's default, or ``"flash"``, the
    kernel)."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens, frontend_embeds)
    b, s_total = x.shape[0], x.shape[1]
    max_len = max_len or s_total
    cap = _cache_cap(cfg, max(max_len, s_total))
    dt = kv_cache_dtype(cfg)
    shape = (cfg.n_layers, b, cap, cfg.n_kv_heads, cfg.head_dim)
    ck = torch.zeros(shape, dtype=dt, device=x.device)
    cv = torch.zeros(shape, dtype=dt, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v) = _seq_layer(cfg, impl, x, layer_params(params["layers"], i))
        _kv_into_ring(k, v, ck[i], cv[i])
    if last_only:
        x = x[:, -1:]
    lengths = torch.full((cfg.n_layers, b), s_total, dtype=torch.int32, device=x.device)
    state = DecodeState({"kv": attn.KVCache(ck, cv, lengths)},
                        torch.full((b,), s_total, dtype=torch.int32, device=x.device))
    return _logits(params, cfg, x), state


def decode_step(params: Params, cfg: ModelConfig, state: DecodeState,
                token: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """token: (B,) int -> (logits (B, V), new state).  The caches of
    ``state`` are written in place (the new state shares them), so ``state``
    is not reusable as the old state."""
    x = params["embed"][token.long()][:, None, :]                    # (B,1,d)
    kv = state.layers["kv"]
    lengths = []
    for i in range(cfg.n_layers):
        cache = {"kv": attn.KVCache(kv.k[i], kv.v[i], kv.length[i])}
        x, new = _decode_layer(cfg, x, layer_params(params["layers"], i), cache)
        lengths.append(new["kv"].length)
    logits = _logits(params, cfg, x)[:, 0]
    new_kv = attn.KVCache(kv.k, kv.v, torch.stack(lengths))
    return logits, DecodeState({"kv": new_kv}, state.step + 1, state.cross_kv)
