"""The benchmark's one traffic generator: a federation drawn from a seed.

A traffic mix is a JSON file beside this module (``<mix>.json``) of plain
parameters; :func:`load_mix` reads it and :func:`make_federation` draws the
data.  The token stream is the program's synthetic k-gram stream (each
``order``-token context hashes into one of ``n_ctx`` buckets that prefer
four next tokens; with probability ``1 - p_follow`` a uniform token comes
instead), drawn here in NumPy for all sequences at once: each sequence of
``seq_len + 1`` tokens runs its own chain, so one seed's data is drawn in a
few array operations.

``seqs_per_device`` is an integer, or ``{"median": m, "sigma": s, "min":
a, "max": b}`` for lognormal sizes clipped to [a, b]; such sizes come from
``size_seed`` and are only shuffled over the devices by the run's seed, so
every seed gets the same set of sizes.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def load_mix(name: str, where: Path = HERE) -> dict:
    return json.loads((where / f"{name}.json").read_text())


def token_stream(n_seq: int, seq_len: int, vocab: int, rng: np.random.Generator,
                 order: int = 3, n_ctx: int = 997, p_follow: float = 0.85) -> np.ndarray:
    """(n_seq, seq_len + 1) int64 tokens, each row one k-gram chain."""
    table = rng.integers(0, vocab, size=(n_ctx, 4))
    mults = rng.integers(1, n_ctx, size=order)
    width = seq_len + 1
    toks = np.empty((n_seq, width), np.int64)
    toks[:, :order] = rng.integers(0, vocab, size=(n_seq, order))
    follow = rng.random((n_seq, width)) < p_follow
    pick = rng.integers(0, 4, size=(n_seq, width))
    noise = rng.integers(0, vocab, size=(n_seq, width))
    for t in range(order, width):
        h = sum(toks[:, t - 1 - i] * int(mults[i]) for i in range(order)) % n_ctx
        toks[:, t] = np.where(follow[:, t], table[h, pick[:, t]], noise[:, t])
    return toks


def device_sizes(mix: dict, seed: int) -> np.ndarray:
    spec = mix["seqs_per_device"]
    n = mix["n_devices"]
    if isinstance(spec, int):
        return np.full(n, spec, np.int64)
    sizes = np.random.default_rng(spec.get("size_seed", 0)).lognormal(
        np.log(spec["median"]), spec["sigma"], n)
    sizes = np.clip(np.round(sizes), spec["min"], spec["max"]).astype(np.int64)
    return np.random.default_rng(seed).permutation(sizes)


@dataclass
class Federation:
    """The inputs both sides get: every device's sequences and the test set,
    on ``device``; ``client_rows[i]`` are device i's rows of ``train_x``."""

    train_x: torch.Tensor
    train_y: torch.Tensor
    test_x: torch.Tensor
    test_y: torch.Tensor
    client_rows: List[np.ndarray]
    sizes: np.ndarray

    @property
    def n_devices(self) -> int:
        return len(self.client_rows)

    def client(self, cid: int):
        rows = torch.as_tensor(self.client_rows[int(cid)], device=self.train_x.device)
        return self.train_x[rows], self.train_y[rows]


def make_federation(mix: dict, vocab: int, seed: int, device) -> Federation:
    """Draw the mix's federation from ``seed``: devices own contiguous runs
    of sequences, the test set follows."""
    sizes = device_sizes(mix, seed)
    stream = mix.get("stream", {})
    n_train = int(sizes.sum())
    toks = token_stream(n_train + mix["test_seqs"], mix["seq_len"], vocab,
                        np.random.default_rng(seed), **stream)
    ends = np.cumsum(sizes)
    rows = [np.arange(e - s, e) for s, e in zip(sizes, ends)]
    t = torch.as_tensor(toks, device=device)
    return Federation(t[:n_train, :-1].contiguous(), t[:n_train, 1:].contiguous(),
                      t[n_train:, :-1].contiguous(), t[n_train:, 1:].contiguous(),
                      rows, sizes)
