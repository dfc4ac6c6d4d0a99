"""The LM of the reference's model zoo: the attention, SSM and hybrid
families.

One parameterized decoder built from

* ``dense``: GQA attention (full or sliding-window) + (Ge)GLU / relu2 FFN
  (yi-6b, gemma-7b, minitron-4b, h2o-danube-3-4b);
* ``ssm`` (rwkv6-3b): RWKV6 time mix (data-dependent decay) + channel mix,
  no positions;
* ``hybrid`` (hymba-1.5b): sliding-window attention and Mamba heads in
  parallel on the same normed input, averaged, then the FFN.

Other families are refused where a model is built or run
(:func:`init_params`, :func:`forward`, :func:`prefill`,
:func:`init_decode_state`), naming the slice of the port that brings them:
mixture-of-experts layers, whisper's encoder-decoder and internvl2's
frontend.

Parameters are the reference's pytree as nested dicts of tensors:
``{"embed", "final_norm", "layers": {...}, "lm_head"}``, every ``layers``
leaf stacked over a leading ``L`` axis.  The layer loop is a Python loop
over ``L`` that indexes those leaves (views, no copies) in place of
``lax.scan``.  ``cfg.remat`` checkpoints each layer of :func:`forward`
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``) when
autograd records it; :func:`prefill` and the decode steps never
differentiate and ignore it.  The decode state's caches are stacked the
same way.
:func:`decode_step` leaves its input state as it was and returns a new one,
as the reference does; the serving loops, which own their state and never
reuse the old one, call :func:`_decode_step_into`, which writes the caches
in place.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_init,
    init_mlp,
    init_norm,
    sinusoidal_positions,
    softmax_xent,
)

Params = Dict[str, Any]

MOE_SLICE = ("the MoE / encoder-decoder / frontend slice (models/moe.py, "
             "whisper's encoder and cross-attention, internvl2's frontend)")


class DecodeState(NamedTuple):
    layers: Any                      # {"kv": KVCache, "mamba": MambaState,
    #                                  "rwkv": RWKVState} of (L, B, ...) tensors
    step: torch.Tensor               # (B,) int32: tokens processed per sequence
    cross_kv: Optional[Any] = None   # whisper: stacked (k, v) from encoder


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the slice of the port that brings
    ``cfg``'s family, unless it is a family the port runs."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: mixture-of-experts layers are not "
                                  f"ported yet; they come with {MOE_SLICE}")
    if cfg.enc_dec:
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder is not ported "
                                  f"yet; it comes with {MOE_SLICE}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend.kind} frontend is "
                                  f"not ported yet; it comes with {MOE_SLICE}")
    if cfg.attention not in ("full", "swa", "hybrid", "none"):
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
    }
    if cfg.attention == "none":  # rwkv
        layers["time_mix"] = ssm_lib.init_rwkv_time_mix(gen, cfg, dtype, lead)
        layers["channel_mix"] = ssm_lib.init_rwkv_channel_mix(gen, cfg, dtype, lead)
    else:
        layers["attn"] = attn.init_attention(gen, cfg, dtype, lead)
        if cfg.attention == "hybrid":
            layers["mamba"] = ssm_lib.init_mamba(gen, cfg, dtype, lead)
        layers["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype, lead)
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


def _mixer_impl(impl: str) -> str:
    """The SSM mixers' route for the model's ``impl``: the kernels under
    ``"flash"``, the reference's default math otherwise."""
    if impl not in attn.IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {attn.IMPLS}")
    return "cuda" if impl == "flash" else "xla"


def _seq_layer(cfg: ModelConfig, impl: str, x: torch.Tensor, lp: Params
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One layer over a full sequence, from zero recurrent state: (x, the
    layer's cache material): ``{"rwkv": RWKVState}`` for RWKV6, else
    ``{"kv": (k, v)}`` and, for the hybrid, ``"mamba": MambaState``."""
    b = x.shape[0]
    h = apply_norm(cfg.norm, lp["norm1"], x)
    if cfg.attention == "none":
        st0 = ssm_lib.init_rwkv_state(cfg, b, x.device)
        y, st = ssm_lib.rwkv_time_mix_chunked(lp["time_mix"], h, st0, cfg,
                                              impl=_mixer_impl(impl))
        x = x + y
        h = apply_norm(cfg.norm, lp["norm2"], x)
        y, last_cm = ssm_lib.rwkv_channel_mix(lp["channel_mix"], h, torch.zeros_like(h[:, 0]))
        return x + y, {"rwkv": ssm_lib.RWKVState(st.wkv, st.shift_tm, last_cm)}
    a_out, kv = attn.attention_prefill(lp["attn"], h, cfg, causal=True,
                                       window=_window(cfg), impl=impl)
    cache: Dict[str, Any] = {"kv": kv}
    if cfg.attention == "hybrid":
        m0 = ssm_lib.init_mamba_state(cfg, b, x.device)
        m_out, cache["mamba"] = ssm_lib.mamba_scan(lp["mamba"], h, m0, cfg,
                                                   impl=_mixer_impl(impl))
        a_out = 0.5 * (a_out + m_out)
    x = x + a_out
    h = apply_norm(cfg.norm, lp["norm2"], x)
    return x + apply_mlp(lp["mlp"], h, cfg.activation), cache


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, d).  ``frontend_embeds`` keeps the reference's
    signature; the VLM frontend comes with its slice, so it is unused here."""
    return params["embed"][tokens.long()]


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def _remat(cfg: ModelConfig, x: torch.Tensor) -> bool:
    """Whether :func:`forward` checkpoints its layers: ``cfg.remat`` is set,
    autograd records, and no ``torch.func`` transform is tracking ``x``.
    Under ``torch.func`` (the vmapped FL executor's ``vmap(grad(...))``)
    ``torch.utils.checkpoint`` raises, as functorch does not support saved
    tensor hooks; there the layers run plain, with the same numbers and
    more memory.  A transform is detected by the layer input being a
    functorch-wrapped tensor."""
    return (cfg.remat and torch.is_grad_enabled()
            and not torch._C._functorch.is_functorch_wrapped_tensor(x))


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            impl: str = "naive") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. tokens: (B, S). Returns (logits, aux_loss);
    ``aux`` is 0 for the supported families (MoE adds its router losses).
    ``impl`` picks every mixer's route, as in :func:`prefill`.  Models
    without RoPE that attend (a stripped whisper) add the reference's
    sinusoidal positions; RWKV6 is position-free."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens, frontend_embeds)
    if not cfg.use_rope and cfg.attention != "none":
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    remat = _remat(cfg, x)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        if remat:
            x = checkpoint(lambda h, lp: _seq_layer(cfg, impl, h, lp)[0], x, lp,
                           use_reentrant=False)
        else:
            x, _ = _seq_layer(cfg, impl, x, lp)
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


def _zero_caches(cfg: ModelConfig, batch: int, cap: int, dev: torch.device
                 ) -> Dict[str, Any]:
    """Zeroed caches stacked over L: the ring K/V (capacity ``cap``) of the
    attention layers, the Mamba state of the hybrid's, RWKV6's state."""
    lead = (cfg.n_layers,)
    if cfg.attention == "none":
        return {"rwkv": ssm_lib.init_rwkv_state(cfg, batch, dev, lead)}
    shape = lead + (batch, cap, cfg.n_kv_heads, cfg.head_dim)
    dt = kv_cache_dtype(cfg)
    layers: Dict[str, Any] = {"kv": attn.KVCache(
        torch.zeros(shape, dtype=dt, device=dev), torch.zeros(shape, dtype=dt, device=dev),
        torch.zeros(lead + (batch,), dtype=torch.int32, device=dev))}
    if cfg.attention == "hybrid":
        layers["mamba"] = ssm_lib.init_mamba_state(cfg, batch, dev, lead)
    return layers


def _layer_caches(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i``'s caches: views of the stacked ones."""
    return {name: type(c)(*(t[i] for t in c)) for name, c in layers.items()}


def _store(dst: Tuple[torch.Tensor, ...], src: Tuple[torch.Tensor, ...]) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def init_decode_state(params: Params, cfg: ModelConfig, batch: int,
                      max_len: int) -> DecodeState:
    """Allocate per-layer caches (stacked over L) on the params' device: ring
    K/V caches, and the Mamba or RWKV6 recurrent states."""
    check_supported(cfg)
    dev = params["embed"].device
    return DecodeState(_zero_caches(cfg, batch, _cache_cap(cfg, max_len), dev),
                       torch.zeros((batch,), dtype=torch.int32, device=dev))


def _decode_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params,
                  cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """One-token layer step. x: (B,1,d).  Writes the K/V ring in place and
    returns the layer's new caches.  The SSM mixers go through the kernels'
    ops (the reference's decode has no ``impl``: on the card the ops launch
    the kernels, on the CPU they take the plain versions)."""
    h = apply_norm(cfg.norm, lp["norm1"], x)
    if cfg.attention == "none":
        st = cache["rwkv"]
        y, st2 = ssm_lib.rwkv_time_mix_recurrent(lp["time_mix"], h, st, cfg)
        x = x + y
        h = apply_norm(cfg.norm, lp["norm2"], x)
        y, last_cm = ssm_lib.rwkv_channel_mix(lp["channel_mix"], h, st.shift_cm)
        return x + y, {"rwkv": ssm_lib.RWKVState(st2.wkv, st2.shift_tm, last_cm)}
    a_out, kv2 = attn.attention_decode(lp["attn"], h, cache["kv"], cfg, window=_window(cfg))
    new = {"kv": kv2}
    if cfg.attention == "hybrid":
        m_out, new["mamba"] = ssm_lib.mamba_scan(lp["mamba"], h, cache["mamba"], cfg,
                                                 impl="cuda")
        a_out = 0.5 * (a_out + m_out)
    x = x + a_out
    h = apply_norm(cfg.norm, lp["norm2"], x)
    return x + apply_mlp(lp["mlp"], h, cfg.activation), new


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
    avoids materializing the (B, S, V) tensor).

    ``impl`` picks the route of every prompt-length mixer: ``"naive"`` is
    the reference's default math throughout (naive attention, the per-token
    Mamba scan, RWKV6's chunkwise einsums); ``"flash"`` runs the three
    kernels (``flash_attention``, the ``mamba`` selective scan, the
    ``rwkv6`` WKV), one launch of each per layer that has that mixer.  The
    primed state holds the ring K/V caches, and Hymba's Mamba or RWKV6's
    recurrent state after the prompt."""
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens, frontend_embeds)
    b, s_total = x.shape[0], x.shape[1]
    max_len = max_len or s_total
    layers = _zero_caches(cfg, b, _cache_cap(cfg, max(max_len, s_total)), x.device)
    for i in range(cfg.n_layers):
        x, got = _seq_layer(cfg, impl, x, layer_params(params["layers"], i))
        dst = _layer_caches(layers, i)
        for name, c in got.items():
            if name == "kv":
                _kv_into_ring(*c, dst["kv"].k, dst["kv"].v)
            else:
                _store(dst[name], c)
    if "kv" in layers:
        layers["kv"].length.fill_(s_total)
    if last_only:
        x = x[:, -1:]
    state = DecodeState(layers, torch.full((b,), s_total, dtype=torch.int32, device=x.device))
    return _logits(params, cfg, x), state


def _decode_step_into(params: Params, cfg: ModelConfig, state: DecodeState,
                      token: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """:func:`decode_step` writing into ``state``'s caches in place: the new
    state shares them, so ``state`` is not reusable as the old state.  For
    callers that own their state (``launch/serve.py``,
    ``launch/scheduler.py``)."""
    x = params["embed"][token.long()][:, None, :]                    # (B,1,d)
    for i in range(cfg.n_layers):
        cache = _layer_caches(state.layers, i)
        x, new = _decode_layer(cfg, x, layer_params(params["layers"], i), cache)
        for name, c in new.items():
            if name == "kv":                  # K/V went into the ring in place
                cache["kv"].length.copy_(c.length)
            else:
                _store(cache[name], c)
    logits = _logits(params, cfg, x)[:, 0]
    return logits, DecodeState(state.layers, state.step + 1, state.cross_kv)


def decode_step(params: Params, cfg: ModelConfig, state: DecodeState,
                token: torch.Tensor) -> Tuple[torch.Tensor, DecodeState]:
    """token: (B,) int -> (logits (B, V), new state).  ``state`` is left as
    it was, as in the reference: the caches are cloned once, then
    :func:`_decode_step_into` writes the clones."""
    layers = {name: type(c)(*(t.clone() for t in c)) for name, c in state.layers.items()}
    return _decode_step_into(params, cfg, DecodeState(layers, state.step, state.cross_kv),
                             token)
