"""Step functions (the training step, serving's prefill and decode steps)
and shape stand-ins of every step input for every (arch x shape).

The stand-ins (:func:`params_struct`, :func:`opt_struct`,
:func:`batch_specs`, :func:`decode_state_struct`, :func:`input_specs`) are
the reference's ``jax.eval_shape`` results as tensors on the ``meta``
device: the same shapes and dtypes, no storage on any device.  The dry-run
(:mod:`repro_torch.launch.dryrun`) places them on a mesh as DTensors over
fake local shards.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.fl._tree import tree_leaves, tree_map_with_path, tree_unflatten
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, adamw, linear_warmup_cosine


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Token positions available for text after frontend tokens (VLM)."""
    if cfg.frontend is not None and not cfg.enc_dec:
        return max(1, shape.seq_len - cfg.frontend.n_tokens)
    return shape.seq_len


def _meta(tree: Any) -> Any:
    """The same tree with every tensor leaf as a ``meta`` tensor of its
    shape and dtype."""
    def to_meta(_, t):
        if isinstance(t, torch.Tensor):
            return torch.empty(t.shape, dtype=t.dtype, device="meta")
        return t

    return tree_map_with_path(to_meta, tree)


def params_struct(cfg: ModelConfig) -> Any:
    """:func:`~repro_torch.models.transformer.init_params`'s tree as meta
    tensors (traced under ``FakeTensorMode``: no weights are drawn)."""
    with FakeTensorMode():
        params = T.init_params(0, cfg, "cpu")
    return _meta(params)


def opt_struct(cfg: ModelConfig, optimizer: Optimizer) -> Any:
    return optimizer.init(params_struct(cfg))


def _frontend_struct(cfg: ModelConfig, b: int) -> torch.Tensor:
    fe = cfg.frontend
    n = fe.n_tokens if not cfg.enc_dec else cfg.enc_seq
    return torch.empty((b, n, fe.embed_dim), dtype=T.torch_dtype(cfg.dtype), device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    b = shape.global_batch
    s = text_len(cfg, shape)
    batch = {
        "tokens": torch.empty((b, s), dtype=torch.int32, device="meta"),
        "labels": torch.empty((b, s), dtype=torch.int32, device="meta"),
    }
    if cfg.frontend is not None:
        batch["frontend_embeds"] = _frontend_struct(cfg, b)
    return batch


def decode_state_struct(cfg: ModelConfig, shape: ShapeConfig) -> T.DecodeState:
    """The decode state of ``shape.global_batch`` sequences of capacity
    ``shape.seq_len``; whisper's cross-attention K/V come from its encoder
    run on meta tensors."""
    b = shape.global_batch
    fe = _frontend_struct(cfg, b) if cfg.frontend is not None else None
    return T.init_decode_state(params_struct(cfg), cfg, b, shape.seq_len,
                               frontend_embeds=fe)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """All step inputs as meta tensors (no device allocation)."""
    if shape.mode == "train":
        return {"batch": batch_specs(cfg, shape)}
    if shape.mode == "prefill":
        bs = batch_specs(cfg, shape)
        bs.pop("labels")
        return {"batch": bs}
    # decode
    return {
        "token": torch.empty((shape.global_batch,), dtype=torch.int32, device="meta"),
        "state": decode_state_struct(cfg, shape),
    }


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


def make_serve_step(cfg: ModelConfig, impl: str = "flash"
                    ) -> Callable[[Any, T.DecodeState, torch.Tensor],
                                  Tuple[torch.Tensor, T.DecodeState]]:
    """One decode step: ONE new token against the full KV cache; ``impl``
    picks the SSM mixers' route (the kernels under ``"flash"``)."""

    def serve_step(params, state, token):
        return T.decode_step(params, cfg, state, token, impl)

    return serve_step
