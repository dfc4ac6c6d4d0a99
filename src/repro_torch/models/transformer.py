"""The LM of the reference's model zoo: one parameterized decoder (and an
optional encoder) covering every family.

* ``dense`` / ``vlm``: GQA attention (full or sliding-window) + (Ge)GLU /
  relu2 FFN (yi-6b, gemma-7b, minitron-4b, h2o-danube-3-4b); internvl2-76b
  prepends its frontend's image embeddings to the text;
* ``moe`` (olmoe-1b-7b, phi3.5-moe): GQA attention + a top-k expert FFN
  (:mod:`repro_torch.models.moe`), whose router losses make ``aux``;
* ``ssm`` (rwkv6-3b): RWKV6 time mix (data-dependent decay) + channel mix,
  no positions;
* ``hybrid`` (hymba-1.5b): sliding-window attention and Mamba heads in
  parallel on the same normed input, averaged, then the FFN;
* ``audio`` (whisper-medium): a bidirectional encoder over the frontend's
  frames and a causal decoder with cross-attention, both with sinusoidal
  positions;
* ``attention="mla"`` (the port-only deepseek-v2-lite): multi-head latent
  attention (:func:`repro_torch.models.attention.mla_prefill`) in every
  layer; ``cfg.first_k_dense`` dense layers (FFN width ``cfg.d_ff_dense``)
  come first, then the expert layers.  Training and evaluation only:
  :func:`prefill` and the decode steps refuse it (no latent KV cache).

Parameters are the reference's pytree as nested dicts of tensors:
``{"embed", "final_norm", "layers": {...}, "lm_head"}``, plus
``"encoder": {"layers", "final_norm"}`` for the encoder-decoder and
``"frontend_proj"`` where the frontend's width is not d_model, and
``"dense_layers"`` (the leading dense layers) beside ``"layers"`` where
``cfg.first_k_dense`` is set; every ``layers`` leaf is stacked over a
leading ``L`` axis, each group over its own.  The layer loop is a
Python loop over ``L`` in place of ``lax.scan``; a stack takes its layers'
weights as views from one ``unbind`` of each leaf along ``L``, not from one
select a leaf and layer: the backward of the ``unbind`` is one ``stack`` of
the ``L`` layer gradients, while each select's backward zero-fills a buffer
of the whole stacked leaf for its slice and autograd sums the ``L`` buffers
(``L`` fills and ``L - 1`` adds of the leaf a step, every element written by
one layer).  On a mesh the ``L`` axis is never sharded, so a DTensor leaf
unbinds into ``L`` DTensor views, each layer's FSDP shards gathered as it
runs.  ``cfg.remat`` checkpoints each layer of
:func:`forward`, the encoder's too, as the reference's ``jax.checkpoint``
does, whenever a backward will run: ``torch.utils.checkpoint`` under plain
autograd, and under a ``torch.func`` transform (the vmapped FL executor's
``vmap(grad(...))``) :class:`_LayerCheckpoint`, which saves the layer's
inputs and recomputes the layer in its backward; :func:`prefill` and the
decode steps never differentiate and ignore it.
The decode state's caches are stacked the same way.
:func:`decode_step` leaves its input state as it was and returns a new one,
as the reference does; the serving loops, which own their state and never
reuse the old one, call :func:`_decode_step_into`, which writes the caches
in place.  Whisper's cross-attention K/V (``DecodeState.cross_kv``) are
read-only and shared by both.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch._C._functorch import TransformType, _unwrap_for_grad, _wrap_for_grad
from torch._functorch.pyfunctorch import retrieve_current_functorch_interpreter
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.sharding import distribute_like, embed_lookup, gather_fsdp, shard
from repro_torch.models.layers import (
    apply_mlp,
    apply_norm,
    embed_init,
    init_mlp,
    init_norm,
    sinusoidal_at,
    sinusoidal_positions,
    softmax_xent,
)

Params = Dict[str, Any]


class DecodeState(NamedTuple):
    layers: Any                      # {"kv": KVCache, "mamba": MambaState,
    #                                  "rwkv": RWKVState} of (L, B, ...) tensors
    step: torch.Tensor               # (B,) int32: tokens processed per sequence
    cross_kv: Optional[Any] = None   # whisper: stacked (k, v) from encoder,
    #                                  each (L, B, enc_seq, KV, Dh)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for an attention kind no family has."""
    if cfg.attention not in ("full", "swa", "hybrid", "none", "mla"):
        raise ValueError(f"{cfg.name}: unknown attention kind {cfg.attention!r}")


def _refuse_latent_cache(cfg: ModelConfig, what: str) -> None:
    if cfg.attention == "mla":
        raise ValueError(f"{cfg.name}: {what} needs a latent KV cache, which the port "
                         "does not have; multi-head latent attention runs in training "
                         "and evaluation (forward, loss_fn) only")


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (the config's dtype names)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i``'s parameters: views of the stacked leaves, or the
    ``i``-th of a leaf's views that :func:`_unbind_layers` took (on a mesh,
    with their FSDP shards gathered)."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else gather_fsdp(v[i]))
            for k, v in layers.items()}


def _unbind_layers(layers: Params) -> Params:
    """``layers`` with each stacked leaf replaced by the tuple of its layer
    views from one ``unbind`` along ``L``."""
    return {k: (_unbind_layers(v) if isinstance(v, dict) else torch.unbind(v, 0))
            for k, v in layers.items()}


# ===========================================================================
# Init
# ===========================================================================


def _init_layers(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                 dev: torch.device, n: int, *, cross: bool, dense: bool = False) -> Params:
    """``n`` stacked layers (the reference's ``_init_layer`` under
    ``jax.vmap``): norms, the mixer, whisper's cross-attention when
    ``cross``, and the FFN or the experts (``dense``: an MLA model's leading
    dense layers, FFN width ``cfg.d_ff_dense``)."""
    lead = (n,)
    layers: Params = {
        "norm1": init_norm(cfg.norm, cfg.d_model, torch.float32, dev, lead),
        "norm2": init_norm(cfg.norm, cfg.d_model, torch.float32, dev, lead),
    }
    if cfg.attention == "none":  # rwkv
        layers["time_mix"] = ssm_lib.init_rwkv_time_mix(gen, cfg, dtype, lead)
        layers["channel_mix"] = ssm_lib.init_rwkv_channel_mix(gen, cfg, dtype, lead)
        return layers
    if cfg.attention == "mla":
        layers["attn"] = attn.init_mla(gen, cfg, dtype, lead)
        if dense:
            layers["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff_dense, cfg.activation, dtype,
                                     lead)
        else:
            layers["moe"] = moe_lib.init_moe(gen, cfg, dtype, lead)
        return layers
    layers["attn"] = attn.init_attention(gen, cfg, dtype, lead)
    if cfg.attention == "hybrid":
        layers["mamba"] = ssm_lib.init_mamba(gen, cfg, dtype, lead)
    if cross:
        layers["cross_attn"] = attn.init_attention(gen, cfg, dtype, lead, cross=True)
        layers["norm_cross"] = init_norm(cfg.norm, cfg.d_model, torch.float32, dev, lead)
    if cfg.moe is not None:
        layers["moe"] = moe_lib.init_moe(gen, cfg, dtype, lead)
    else:
        layers["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dtype, lead)
    return layers


def init_params(seed: int, cfg: ModelConfig, device: DeviceLike = None) -> Params:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on the
    target device (the card unless ``device="cpu"``), drawn there.  The
    reference's distributions; other numbers than its ``jax.random``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.norm, cfg.d_model, torch.float32, dev),
    }
    if cfg.first_k_dense:
        p["dense_layers"] = _init_layers(gen, cfg, dtype, dev, cfg.first_k_dense, cross=False,
                                         dense=True)
    p["layers"] = _init_layers(gen, cfg, dtype, dev, cfg.n_layers - cfg.first_k_dense,
                               cross=cfg.enc_dec)
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, dtype).T.contiguous()
    if cfg.enc_dec:
        p["encoder"] = {
            "layers": _init_layers(gen, cfg, dtype, dev, cfg.n_enc_layers, cross=False),
            "final_norm": init_norm(cfg.norm, cfg.d_model, torch.float32, dev),
        }
    if cfg.frontend is not None and cfg.frontend.embed_dim != cfg.d_model:
        p["frontend_proj"] = embed_init(gen, cfg.frontend.embed_dim, cfg.d_model, dtype)
    return p


# ===========================================================================
# Layer bodies (sequence / prefill form)
# ===========================================================================


def _window(cfg: ModelConfig) -> Optional[int]:
    return cfg.window if cfg.attention in ("swa", "hybrid") else None


def _mixer_impl(impl: str) -> str:
    """The SSM mixers' route for the model's ``impl``: the kernels under
    ``"flash"``, the reference's default math otherwise."""
    if impl not in attn.IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {attn.IMPLS}")
    return "cuda" if impl == "flash" else "xla"


def _zero_aux(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.float32, device=x.device)


def _ffn(cfg: ModelConfig, lp: Params, h: torch.Tensor
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The layer's FFN: (y, the MoE's aux loss, or None for a dense FFN)."""
    if "moe" in lp:
        y, moe_aux = moe_lib.apply_moe(lp["moe"], h, cfg)
        return y, moe_lib.moe_aux_loss(moe_aux, cfg)
    return apply_mlp(lp["mlp"], h, cfg.activation), None


def _seq_layer(cfg: ModelConfig, impl: str, x: torch.Tensor, lp: Params,
               causal: bool = True, enc_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, Any], torch.Tensor]:
    """One layer over a full sequence, from zero recurrent state: (x, the
    layer's cache material, the layer's fp32 aux loss).  The cache material
    is ``{"rwkv": RWKVState}`` for RWKV6, else ``{"kv": (k, v)}`` and, for
    the hybrid, ``"mamba": MambaState``.  ``enc_out``: the encoder's output
    that a decoder layer of the encoder-decoder cross-attends to;
    ``causal=False`` is the encoder's bidirectional attention."""
    b = x.shape[0]
    aux = _zero_aux(x)
    # residual-stream annotation: "act_seq" maps to the model axis under
    # Megatron-style activation sequence sharding (launch-layer opt-in)
    x = shard(x, "batch", "act_seq", "embed")
    h = apply_norm(cfg.norm, lp["norm1"], x)
    if cfg.attention == "mla":
        x = x + attn.mla_prefill(lp["attn"], h, cfg, impl=impl)
        y, layer_aux = _ffn(cfg, lp, apply_norm(cfg.norm, lp["norm2"], x))
        return x + y, {}, aux if layer_aux is None else aux + layer_aux
    if cfg.attention == "none":
        st0 = ssm_lib.init_rwkv_state(cfg, b, x.device)
        y, st = ssm_lib.rwkv_time_mix_chunked(lp["time_mix"], h, st0, cfg,
                                              impl=_mixer_impl(impl))
        x = x + y
        h = apply_norm(cfg.norm, lp["norm2"], x)
        y, last_cm = ssm_lib.rwkv_channel_mix(lp["channel_mix"], h, torch.zeros_like(h[:, 0]))
        return x + y, {"rwkv": ssm_lib.RWKVState(st.wkv, st.shift_tm, last_cm)}, aux
    a_out, kv = attn.attention_prefill(lp["attn"], h, cfg, causal=causal,
                                       window=_window(cfg), impl=impl)
    cache: Dict[str, Any] = {"kv": kv}
    if cfg.attention == "hybrid":
        m0 = ssm_lib.init_mamba_state(cfg, b, x.device)
        m_out, cache["mamba"] = ssm_lib.mamba_scan(lp["mamba"], h, m0, cfg,
                                                   impl=_mixer_impl(impl))
        a_out = 0.5 * (a_out + m_out)
    x = x + a_out
    if enc_out is not None:
        h = apply_norm(cfg.norm, lp["norm_cross"], x)
        c_out, _ = attn.attention_prefill(lp["cross_attn"], h, cfg,
                                          causal=False, kv_from=enc_out)
        x = x + c_out
    h = apply_norm(cfg.norm, lp["norm2"], x)
    y, layer_aux = _ffn(cfg, lp, h)
    if layer_aux is not None:
        aux = aux + layer_aux
    return x + y, cache, aux


class _LayerCheckpoint(torch.autograd.Function):
    """One layer under ``cfg.remat`` inside a ``torch.func`` transform, where
    ``torch.utils.checkpoint`` cannot run (functorch does not support its
    saved-tensor hooks).  ``forward(run, *flat)``: ``run`` rebuilds the
    layer's arguments from the flat tensors (the layer input, its weights,
    the encoder output) and returns ``(x, aux)``; the non-tensor arguments
    (``cfg``, ``impl``, ``causal``) live in its closure.  Only the flat
    inputs are saved; the backward reruns the layer through
    ``torch.func.vjp`` (``torch.autograd.grad`` does not compose with the
    transforms), and ``generate_vmap_rule`` lets ``vmap`` batch both passes.

    ``torch.func.grad`` differentiates with ``create_graph=True``, so what a
    backward computes is recorded at the transform's own level: a graph no
    one reads (the level ends with that backward) that would keep every
    recomputed layer's tensors alive until it ends.  Under a grad transform
    the backward therefore runs one level lower, where an enclosing
    transform still records what a higher derivative needs, and hands its
    results back to its level as constants."""

    generate_vmap_rule = True

    @staticmethod
    def forward(run, *flat):
        return run(*flat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.run = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *grads):
        saved = ctx.saved_tensors
        top = torch._C._functorch.peek_interpreter_stack()
        if top is None or top.key() != TransformType.Grad:
            return (None, *_layer_vjp(ctx.run, saved, grads))
        interp = retrieve_current_functorch_interpreter()
        level = interp.level()
        down = [None if t is None else _unwrap_for_grad(t, level) for t in (*saved, *grads)]
        with interp.lower():
            cot = _layer_vjp(ctx.run, down[:len(saved)], down[len(saved):])
        return (None, *(_wrap_for_grad(t, level) for t in cot))

    @staticmethod
    def jvp(ctx, *tangents):
        raise NotImplementedError(
            "cfg.remat under a torch.func transform checkpoints each layer with a "
            "reverse-mode rule only; forward-mode AD (torch.func.jvp, jacfwd, "
            "hessian) needs cfg.remat=False")


def _layer_vjp(run, saved, grads):
    """The cotangents of ``run``'s inputs ``saved`` for its outputs'
    ``grads``; an output nothing downstream used (a dense layer's aux) may
    come back as None."""
    out, vjp = torch.func.vjp(run, *saved)
    return vjp(tuple(torch.zeros_like(o) if g is None else g for o, g in zip(out, grads)))


def _checkpoint_layer(body, x: torch.Tensor, lp: Params,
                      enc_out: Optional[torch.Tensor]):
    """``body(x, lp, enc_out)`` through :class:`_LayerCheckpoint`.  Each
    application adds one to ``_checkpoint_layer.applied``."""
    leaves, spec = tree_flatten(lp)
    n = len(leaves)

    def run(h, *rest):
        return body(h, tree_unflatten(list(rest[:n]), spec), rest[n] if rest[n:] else None)

    _checkpoint_layer.applied += 1
    return _LayerCheckpoint.apply(run, x, *leaves, *(() if enc_out is None else (enc_out,)))


_checkpoint_layer.applied = 0


def _remat(cfg: ModelConfig, x: torch.Tensor, layers: Params) -> Optional[str]:
    """How a stack checkpoints its layers: ``None`` (run plain) when
    ``cfg.remat`` is off or autograd records nothing; ``"func"``
    (:class:`_LayerCheckpoint`) when a ``torch.func`` transform tracks the
    stack's input or its weights, which a functorch-wrapped tensor shows;
    else ``"autograd"`` (``torch.utils.checkpoint``)."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return None
    wrapped = torch._C._functorch.is_functorch_wrapped_tensor
    return "func" if wrapped(x) or wrapped(layers["norm1"]["scale"]) else "autograd"


def _run_stack(cfg: ModelConfig, impl: str, causal: bool, x: torch.Tensor,
               layers: Params, n: int, enc_out: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` stacked layers over a full sequence: (x, the layers' aux summed
    in fp32).  The layers' weights come from :func:`_unbind_layers`; each
    layer is checkpointed by the route :func:`_remat` picks, its aux with
    it."""
    aux = _zero_aux(x)
    route = _remat(cfg, x, layers)
    views = _unbind_layers(layers)

    def body(h, lp, eo):
        out, _, a = _seq_layer(cfg, impl, h, lp, causal, eo)
        return out, a

    for i in range(n):
        lp = layer_params(views, i)
        if route == "autograd":
            x, a = checkpoint(body, x, lp, enc_out, use_reentrant=False)
        elif route == "func":
            x, a = _checkpoint_layer(body, x, lp, enc_out)
        else:
            x, a = body(x, lp, enc_out)
        aux = aux + a
    return x, aux


def _frontend(params: Params, fe: torch.Tensor) -> torch.Tensor:
    return fe @ params["frontend_proj"] if "frontend_proj" in params else fe


def _need_frontend(cfg: ModelConfig, frontend_embeds: Optional[torch.Tensor]) -> None:
    if frontend_embeds is None:
        n = cfg.enc_seq if cfg.enc_dec else cfg.frontend.n_tokens
        raise ValueError(f"{cfg.name} needs frontend_embeds of shape (B, {n}, "
                         f"{cfg.frontend.embed_dim}): its {cfg.frontend.kind} "
                         "frontend's output")


def _encode(params: Params, cfg: ModelConfig, frontend_embeds: Optional[torch.Tensor],
            impl: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whisper's encoder over the frames (+ sinusoidal positions),
    bidirectional, then its final norm: (enc_out, the encoder's aux)."""
    _need_frontend(cfg, frontend_embeds)
    eo = _frontend(params, frontend_embeds)
    eo = eo + sinusoidal_positions(eo.shape[1], cfg.d_model, eo.device)[None].to(eo.dtype)
    eo = shard(eo, "batch", "seq", "embed")
    enc = params["encoder"]
    enc_out, aux = _run_stack(cfg, impl, False, eo, enc["layers"], cfg.n_enc_layers)
    return apply_norm(cfg.norm, enc["final_norm"], enc_out), aux


# ===========================================================================
# Forward (training / prefill logits)
# ===========================================================================


def embed_tokens(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                 frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings (B, S, d); for the VLM, the frontend's embeddings
    (through ``frontend_proj`` where present) come first: (B, n + S, d)."""
    x = embed_lookup(params["embed"], tokens.long())
    if cfg.frontend is not None and not cfg.enc_dec:
        _need_frontend(cfg, frontend_embeds)
        x = torch.cat([_frontend(params, frontend_embeds).to(x.dtype), x], dim=1)
    return x


def _positions(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Add the sinusoidal positions of a model that attends without RoPE
    (whisper's decoder); RWKV6 is position-free."""
    if not cfg.use_rope and cfg.attention != "none":
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, x.device)[None].to(x.dtype)
    return shard(x, "batch", "seq", "embed")


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg.norm, params["final_norm"], x)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return shard(logits, "batch", "seq", "vocab")


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            impl: str = "naive") -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence logits. tokens: (B, S_text). For the VLM,
    frontend_embeds (B, n_tok, fe_dim) are prepended. For whisper,
    frontend_embeds are the encoder frames (B, enc_seq, d). Returns
    (logits, aux_loss): the MoE layers' router losses summed in fp32 (0
    for the other families).  ``impl`` picks every mixer's route, as in
    :func:`prefill`."""
    check_supported(cfg)
    enc_out, enc_aux = None, None
    if cfg.enc_dec:
        enc_out, enc_aux = _encode(params, cfg, frontend_embeds, impl)
    x = embed_tokens(params, cfg, tokens, frontend_embeds if not cfg.enc_dec else None)
    x = _positions(cfg, x)
    if cfg.first_k_dense:
        x, dense_aux = _run_stack(cfg, impl, True, x, params["dense_layers"], cfg.first_k_dense)
        x, aux = _run_stack(cfg, impl, True, x, params["layers"],
                            cfg.n_layers - cfg.first_k_dense)
        return _logits(params, cfg, x), dense_aux + aux
    x, aux = _run_stack(cfg, impl, True, x, params["layers"], cfg.n_layers, enc_out)
    if enc_aux is not None:
        aux = aux + enc_aux
    return _logits(params, cfg, x), aux


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            impl: str = "naive") -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token LM loss. batch: tokens (B,S), labels (B,S), optional
    frontend_embeds, loss_mask.  The VLM's loss covers the text positions
    only (after the frontend's tokens)."""
    logits, aux = forward(params, cfg, batch["tokens"], batch.get("frontend_embeds"),
                          impl=impl)
    if cfg.frontend is not None and not cfg.enc_dec:
        logits = logits[:, cfg.frontend.n_tokens:]
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
        if isinstance(d, DTensor):        # in place: the source takes d's layout
            s = distribute_like(s, d)
        d.copy_(s)


def _cross_kv(params: Params, cfg: ModelConfig, enc_out: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross-attention K/V of ``enc_out``, stacked:
    two (L, B, enc_seq, KV, Dh) tensors."""
    b = enc_out.shape[0]
    ca = params["layers"]["cross_attn"]
    k = torch.stack([(enc_out @ gather_fsdp(ca["wk"][i])).reshape(b, -1, cfg.n_kv_heads, cfg.head_dim)
                     for i in range(cfg.n_layers)])
    v = torch.stack([(enc_out @ gather_fsdp(ca["wv"][i])).reshape(b, -1, cfg.n_kv_heads, cfg.head_dim)
                     for i in range(cfg.n_layers)])
    return k, v


def init_decode_state(params: Params, cfg: ModelConfig, batch: int,
                      max_len: int, frontend_embeds: Optional[torch.Tensor] = None,
                      impl: str = "naive") -> DecodeState:
    """Allocate per-layer caches (stacked over L) on the params' device: ring
    K/V caches, and the Mamba or RWKV6 recurrent states.  For whisper, also
    runs the encoder over ``frontend_embeds`` (by ``impl``'s route) and
    precomputes the stacked cross-attention K/V."""
    check_supported(cfg)
    _refuse_latent_cache(cfg, "decode")
    dev = params["embed"].device
    cross_kv = None
    if cfg.enc_dec:
        enc_out, _ = _encode(params, cfg, frontend_embeds, impl)
        cross_kv = _cross_kv(params, cfg, enc_out)
    return DecodeState(_zero_caches(cfg, batch, _cache_cap(cfg, max_len), dev),
                       torch.zeros((batch,), dtype=torch.int32, device=dev), cross_kv)


def _decode_layer(cfg: ModelConfig, x: torch.Tensor, lp: Params,
                  cache: Dict[str, Any],
                  cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  impl: str = "flash") -> Tuple[torch.Tensor, Dict]:
    """One-token layer step. x: (B,1,d).  Writes the K/V ring in place and
    returns the layer's new caches.  ``cross_kv``: this layer's (k, v) of
    the encoder output (whisper).  Under ``impl="flash"`` (the default) the
    SSM mixers go through the kernels' ops (on the card the ops launch the
    kernels, on the CPU they take the plain versions, on the dry-run's meta
    tensors their fake implementations); any other ``impl`` takes their
    plain versions on any device, as the reference's decode does.  An MoE
    layer routes the B tokens and drops its aux, as the reference does."""
    h = apply_norm(cfg.norm, lp["norm1"], x)
    if cfg.attention == "none":
        st = cache["rwkv"]
        y, st2 = ssm_lib.rwkv_time_mix_recurrent(lp["time_mix"], h, st, cfg,
                                                 impl=_mixer_impl(impl))
        x = x + y
        h = apply_norm(cfg.norm, lp["norm2"], x)
        y, last_cm = ssm_lib.rwkv_channel_mix(lp["channel_mix"], h, st.shift_cm)
        return x + y, {"rwkv": ssm_lib.RWKVState(st2.wkv, st2.shift_tm, last_cm)}
    a_out, kv2 = attn.attention_decode(lp["attn"], h, cache["kv"], cfg, window=_window(cfg))
    new = {"kv": kv2}
    if cfg.attention == "hybrid":
        m_out, new["mamba"] = ssm_lib.mamba_scan(lp["mamba"], h, cache["mamba"], cfg,
                                                 impl=_mixer_impl(impl))
        a_out = 0.5 * (a_out + m_out)
    x = x + a_out
    if cross_kv is not None:
        h = apply_norm(cfg.norm, lp["norm_cross"], x)
        c_out, _ = attn.attention_decode(lp["cross_attn"], h, cache["kv"], cfg,
                                         cross_kv=cross_kv)
        x = x + c_out
    h = apply_norm(cfg.norm, lp["norm2"], x)
    y, _ = _ffn(cfg, lp, h)
    return x + y, new


def _ring_of(k: torch.Tensor, cap: int, dtype: torch.dtype) -> torch.Tensor:
    """Prefilled K or V (B,S,KV,Dh) as a ring buffer (B,C,KV,Dh) of ``dtype``:
    the one definition of the cache's layout.  Position p sits in slot
    ``p % C``; past the capacity C only the last C positions are kept, and
    below it the slots past S are zero."""
    s = k.shape[1]
    k = k.to(dtype)
    if s <= cap:
        pad = torch.zeros((k.shape[0], cap - s) + tuple(k.shape[2:]), dtype=dtype,
                          device=k.device)
        return torch.cat([k, pad], dim=1)
    kk = k[:, -cap:]
    r = (s - cap) % cap                         # position s - cap + j sits in slot (r + j) % cap
    return torch.cat([kk[:, cap - r:], kk[:, :cap - r]], dim=1)


def _kv_into_ring(k: torch.Tensor, v: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor) -> attn.KVCache:
    """Pack prefilled K/V (B,S,KV,Dh) into the ring buffers ``ck``/``cv``
    (B,C,KV,Dh) (one layer's slice of the stacked cache) in place, in their
    dtype and :func:`_ring_of`'s layout."""
    b, s = k.shape[:2]
    ck.copy_(_ring_of(k, ck.shape[1], ck.dtype))
    cv.copy_(_ring_of(v, cv.shape[1], cv.dtype))
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
    ``rwkv6`` WKV), one launch of each per layer that has that mixer
    (whisper: one bidirectional launch per encoder layer, one causal per
    decoder layer; cross-attention takes the naive route, as in the
    reference).  The primed state holds the ring K/V caches, Hymba's Mamba
    or RWKV6's recurrent state after the prompt, and whisper's stacked
    cross-attention K/V.  The VLM's image tokens count as positions of the
    prompt and of the cache."""
    check_supported(cfg)
    _refuse_latent_cache(cfg, "prefill")
    enc_out, cross_kv = None, None
    if cfg.enc_dec:
        enc_out, _ = _encode(params, cfg, frontend_embeds, impl)
        cross_kv = _cross_kv(params, cfg, enc_out)
    x = embed_tokens(params, cfg, tokens, frontend_embeds if not cfg.enc_dec else None)
    x = _positions(cfg, x)
    b, s_total = x.shape[0], x.shape[1]
    max_len = max_len or s_total
    cap = _cache_cap(cfg, max(max_len, s_total))
    if isinstance(x, DTensor):
        return _prefill_sharded(params, cfg, x, enc_out, cross_kv, cap, impl, last_only)
    layers = _zero_caches(cfg, b, cap, x.device)
    for i in range(cfg.n_layers):
        x, got, _ = _seq_layer(cfg, impl, x, layer_params(params["layers"], i),
                               enc_out=enc_out)
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
    state = DecodeState(layers, torch.full((b,), s_total, dtype=torch.int32, device=x.device),
                        cross_kv)
    return _logits(params, cfg, x), state


def _prefill_sharded(params: Params, cfg: ModelConfig, x: torch.Tensor,
                     enc_out: Optional[torch.Tensor], cross_kv, cap: int, impl: str,
                     last_only: bool) -> Tuple[torch.Tensor, DecodeState]:
    """:func:`prefill` on DTensors: the layers' cache material is stacked
    into new caches (in the dtypes of :func:`_zero_caches`) where the plain
    path writes preallocated ones in place; the caller lays the state out
    (``launch.sharding.decode_state_specs``), as the reference's
    ``out_shardings`` do."""
    b, s_total = x.shape[0], x.shape[1]
    like = _zero_caches(cfg, b, cap, torch.device("meta"))
    got = []
    for i in range(cfg.n_layers):
        x, g, _ = _seq_layer(cfg, impl, x, layer_params(params["layers"], i),
                             enc_out=enc_out)
        got.append(g)
    layers: Dict[str, Any] = {}
    for name, ref in like.items():
        if name == "kv":
            k = torch.stack([_ring_of(g["kv"][0], cap, ref.k.dtype) for g in got])
            v = torch.stack([_ring_of(g["kv"][1], cap, ref.v.dtype) for g in got])
            length = torch.full((cfg.n_layers, b), s_total, dtype=torch.int32,
                                device=x.device)
            layers[name] = attn.KVCache(k, v, length)
        else:
            layers[name] = type(ref)(*(torch.stack([g[name][j] for g in got]).to(r.dtype)
                                       for j, r in enumerate(ref)))
    if last_only:
        x = x[:, -1:]
    state = DecodeState(layers, torch.full((b,), s_total, dtype=torch.int32, device=x.device),
                        cross_kv)
    return _logits(params, cfg, x), state


def _decode_step_into(params: Params, cfg: ModelConfig, state: DecodeState,
                      token: torch.Tensor, impl: str = "flash"
                      ) -> Tuple[torch.Tensor, DecodeState]:
    """:func:`decode_step` writing into ``state``'s caches in place: the new
    state shares them, so ``state`` is not reusable as the old state.  For
    callers that own their state (``launch/serve.py``,
    ``launch/scheduler.py``)."""
    _refuse_latent_cache(cfg, "decode")
    x = params["embed"][token.long()][:, None, :]                    # (B,1,d)
    if not cfg.use_rope and cfg.attention != "none":
        x = x + sinusoidal_at(state.step, cfg.d_model)[:, None].to(x.dtype)
    x = shard(x, "batch", None, "embed")
    for i in range(cfg.n_layers):
        cache = _layer_caches(state.layers, i)
        ckv = None if state.cross_kv is None else (state.cross_kv[0][i], state.cross_kv[1][i])
        x, new = _decode_layer(cfg, x, layer_params(params["layers"], i), cache, ckv, impl)
        for name, c in new.items():
            if name == "kv":                  # K/V went into the ring in place
                _store((cache["kv"].length,), (c.length,))
            else:
                _store(cache[name], c)
    logits = shard(_logits(params, cfg, x)[:, 0], "batch", "vocab")
    return logits, DecodeState(state.layers, state.step + 1, state.cross_kv)


def decode_step(params: Params, cfg: ModelConfig, state: DecodeState,
                token: torch.Tensor, impl: str = "flash"
                ) -> Tuple[torch.Tensor, DecodeState]:
    """token: (B,) int -> (logits (B, V), new state).  ``state`` is left as
    it was, as in the reference: the caches are cloned once, then
    :func:`_decode_step_into` writes the clones.  Whisper's cross-attention
    K/V are only read, so both states share them.  ``impl``: the SSM
    mixers' route (:func:`_decode_layer`)."""
    layers = {name: type(c)(*(t.clone() for t in c)) for name, c in state.layers.items()}
    return _decode_step_into(params, cfg, DecodeState(layers, state.step, state.cross_kv),
                             token, impl)
