"""Continuous-batching serving scheduler.

A fixed pool of B decode slots over ``decode_step`` (``_decode_step_into``:
the batcher owns its state and updates it in place); requests queue up, join
a slot as soon as one frees (their prompt is fed into that slot's cache
region), and leave when they emit ``max_new`` tokens.

Slot-wise prefill uses the token-by-token decode path, as in the reference
(single-sequence prefill into the batched cache would need per-slot cache
scatter; throughput-optimal systems chunk prefill separately).  So this
path launches no attention kernel (decode attention is plain tensor code);
an SSM model's mixers launch their kernel once per layer and step.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.serve import sample
from repro_torch.models import transformer as T


@dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    max_new: int
    out: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None


@dataclass
class ServeStats:
    completed: int
    decode_steps: int
    tokens_out: int
    elapsed_s: float
    tok_per_s: float
    mean_ttft_s: float
    mean_latency_s: float


class ContinuousBatcher:
    """B decode slots multiplexing a stream of requests on ``device`` (the
    card unless ``device="cpu"``), where ``params`` must lie.  Sampling at
    ``temperature`` > 0 draws from a ``torch.Generator`` seeded with
    ``seed``; 0 is greedy.  Whisper needs ``frontend_embeds`` (B, enc_seq,
    d), one slot's audio frames each: its encoder runs once here, and the
    cross-attention K/V it leaves in the state are read by every step and
    kept across slot resets (a slot's requests share its audio)."""

    def __init__(self, cfg: ModelConfig, params, batch_slots: int = 4,
                 max_len: int = 256, temperature: float = 0.0, seed: int = 0,
                 device: DeviceLike = None,
                 frontend_embeds: Optional[torch.Tensor] = None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params are on {params['embed'].device}, the batcher "
                             f"runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.b = batch_slots
        self.max_len = max_len
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = T.init_decode_state(params, cfg, batch_slots, max_len,
                                         frontend_embeds=frontend_embeds)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_prompt_left: List[int] = [0] * batch_slots
        self.cur_token = np.zeros((batch_slots,), np.int32)
        self.queue: Deque[Request] = deque()
        self.completed: List[Request] = []
        self._decode_steps = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        req.submitted_at = time.time()
        self.queue.append(req)

    def _reset_slot_state(self, slot: int) -> None:
        """Zero one slot's caches and step in place: every per-slot leaf
        with leading (L, B) dims (K/V and per-layer cache lengths, the Mamba
        state and conv buffer, RWKV6's WKV state and both token shifts), as
        the reference's ``zero_slot``, so the new request starts fresh while
        other slots keep decoding.  Whisper's cross-attention K/V are not
        per-step state and stay as they are, as in the reference."""
        for cache in self.state.layers.values():
            for leaf in cache:
                if leaf.dim() >= 2 and leaf.shape[:2] == (self.cfg.n_layers, self.b):
                    leaf[:, slot] = 0
        self.state.step[slot] = 0

    def _admit(self) -> None:
        for slot in range(self.b):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.popleft()
                self.slot_req[slot] = req
                self._reset_slot_state(slot)
                self.cur_token[slot] = req.prompt[0]
                self.slot_prompt_left[slot] = len(req.prompt) - 1
            elif self.slot_req[slot] is None:
                self.cur_token[slot] = 0  # idle slot decodes padding

    def step(self) -> None:
        """One batched decode step across all slots."""
        self._admit()
        logits, self.state = T._decode_step_into(
            self.params, self.cfg, self.state,
            torch.as_tensor(self.cur_token, device=self.device))
        self._decode_steps += 1
        toks = sample(logits, self.temperature, self.gen).cpu().numpy()
        now = time.time()
        for slot in range(self.b):
            req = self.slot_req[slot]
            if req is None:
                continue
            if self.slot_prompt_left[slot] > 0:
                # still consuming the prompt: feed the next prompt token
                idx = len(req.prompt) - self.slot_prompt_left[slot]
                self.cur_token[slot] = req.prompt[idx]
                self.slot_prompt_left[slot] -= 1
                continue
            tok = int(toks[slot])
            if req.first_token_at is None:
                req.first_token_at = now
            req.out.append(tok)
            self.cur_token[slot] = tok
            if len(req.out) >= req.max_new:
                req.done_at = now
                self.completed.append(req)
                self.slot_req[slot] = None

    def run(self, max_steps: int = 10_000) -> ServeStats:
        t0 = time.time()
        steps = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            self.step()
            steps += 1
        elapsed = time.time() - t0
        toks = sum(len(r.out) for r in self.completed)
        ttfts = [r.first_token_at - r.submitted_at for r in self.completed
                 if r.first_token_at]
        lats = [r.done_at - r.submitted_at for r in self.completed if r.done_at]
        return ServeStats(
            completed=len(self.completed),
            decode_steps=self._decode_steps,
            tokens_out=toks,
            elapsed_s=elapsed,
            tok_per_s=toks / max(elapsed, 1e-9),
            mean_ttft_s=float(np.mean(ttfts)) if ttfts else 0.0,
            mean_latency_s=float(np.mean(lats)) if lats else 0.0,
        )
