"""Step functions: the training step, serving's prefill and decode steps.

The reference's ``repro.launch.steps`` also builds ``ShapeDtypeStruct``
stand-ins for its XLA dry-run (``params_struct``, ``opt_struct``,
``batch_specs``, ``decode_state_struct``, ``input_specs``); they come with the
port's mesh tooling.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.fl._tree import tree_leaves, tree_unflatten
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, adamw, linear_warmup_cosine


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Token positions available for text after frontend tokens (VLM)."""
    if cfg.frontend is not None and not cfg.enc_dec:
        return max(1, shape.seq_len - cfg.frontend.n_tokens)
    return shape.seq_len


def make_optimizer(total_steps: int = 10_000) -> Optimizer:
    return adamw(linear_warmup_cosine(3e-4, 500, total_steps),
                 weight_decay=0.1, grad_clip=1.0)


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, impl: str = "blocked"
                    ) -> Callable[[Any, Dict[str, Any], Dict[str, torch.Tensor]],
                                  Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]]:
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    {"loss", "xent", "aux"})``: the gradient of :func:`~repro_torch.models.
    transformer.loss_fn` by ``torch.autograd.grad`` over the leaves (in the
    reference's order), then ``optimizer.update``.  The inputs are left as
    they were; the metrics stay device tensors, so a step never waits for
    the host.  ``impl`` is the attention route: ``"blocked"`` (the default,
    as in the reference) or ``"naive"``; ``"flash"`` raises, its kernels
    have no backward.  ``cfg.remat`` checkpoints each layer.  A batch's
    ``frontend_embeds`` (whisper's frames, the VLM's image embeddings) go
    through to the loss with it, and an MoE model's router losses are part
    of the loss (``aux``)."""

    def train_step(params, opt_state, batch):
        live = [leaf.detach().requires_grad_(True) for leaf in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = T.loss_fn(tree_unflatten(params, live), cfg, batch, impl=impl)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        new_params, new_opt = optimizer.update(tree_unflatten(params, list(grads)),
                                               params, opt_state)
        return new_params, new_opt, {"loss": loss.detach(),
                                     **{k: v.detach() for k, v in metrics.items()}}

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, impl: str = "flash"
                      ) -> Callable[[Any, Dict[str, torch.Tensor]],
                                    Tuple[torch.Tensor, T.DecodeState]]:
    """Serving prefill: run the prompt, emit last-position logits + the primed
    decode state (full-seq logits are never materialized).  Prefill goes
    through the kernels by default: flash attention, and the mamba and rwkv6
    kernels for Hymba and RWKV6 (the reference's default here is its XLA
    ``blocked`` attention route, which the port brings with training)."""

    def prefill_step(params, batch):
        logits, state = T.prefill(params, cfg, batch["tokens"],
                                  batch.get("frontend_embeds"),
                                  max_len=shape.seq_len, impl=impl, last_only=True)
        return logits[:, 0], state

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable[[Any, T.DecodeState, torch.Tensor],
                                                  Tuple[torch.Tensor, T.DecodeState]]:
    """One decode step: ONE new token against the full KV cache."""

    def serve_step(params, state, token):
        return T.decode_step(params, cfg, state, token)

    return serve_step
