"""Step functions of the serving path.

The reference's ``repro.launch.steps`` also builds ``ShapeDtypeStruct``
stand-ins for its XLA dry-run (``params_struct``, ``opt_struct``,
``batch_specs``, ``decode_state_struct``, ``input_specs``); they come with the
port's mesh tooling.  ``make_optimizer``/``make_train_step`` come with the LM
training slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer as T


def text_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Token positions available for text after frontend tokens (VLM)."""
    if cfg.frontend is not None and not cfg.enc_dec:
        return max(1, shape.seq_len - cfg.frontend.n_tokens)
    return shape.seq_len


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
