"""Deterministic synthetic classification data (numpy).

The same generator as the reference's ``repro.data.synthetic``: class
prototypes on a sphere, ``prototype + noise`` samples and a fixed random
nonlinear warp, so which clients train measurably moves global accuracy.
The arrays are equal to the reference's for the same arguments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class SyntheticClassificationDataset:
    x: np.ndarray          # (N, dim) float32
    y: np.ndarray          # (N,) int32
    n_classes: int

    def __len__(self) -> int:
        return len(self.y)


def make_classification_data(
    n_samples: int = 20_000,
    n_classes: int = 10,
    dim: int = 32,
    difficulty: float = 1.0,
    seed: int = 0,
) -> Tuple[SyntheticClassificationDataset, SyntheticClassificationDataset]:
    """Returns (train, test). ``difficulty`` scales intra-class noise."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, dim)).astype(np.float32)
    protos /= np.linalg.norm(protos, axis=1, keepdims=True)
    protos *= 3.0
    # a fixed random nonlinear feature warp shared by all samples
    w_warp = rng.normal(size=(dim, dim)).astype(np.float32) / np.sqrt(dim)

    def sample(n, seed2):
        r = np.random.default_rng(seed2)
        y = r.integers(0, n_classes, size=n).astype(np.int32)
        noise = r.normal(size=(n, dim)).astype(np.float32) * difficulty
        x = protos[y] + noise
        x = x + 0.5 * np.tanh(x @ w_warp)          # mild nonlinearity
        return x.astype(np.float32), y

    xtr, ytr = sample(n_samples, seed + 1)
    xte, yte = sample(max(2000, n_samples // 10), seed + 2)
    return (SyntheticClassificationDataset(xtr, ytr, n_classes),
            SyntheticClassificationDataset(xte, yte, n_classes))


def make_lm_stream(
    n_tokens: int = 1 << 16,
    vocab: int = 256,
    order: int = 3,
    seed: int = 0,
) -> np.ndarray:
    """Synthetic token stream with learnable k-gram structure (for training the
    reduced transformer configs end-to-end).  The reference's generator,
    draw for draw: the stream is bit-identical for the same arguments."""
    rng = np.random.default_rng(seed)
    # sparse deterministic-ish transition table: each context maps to a few
    # likely next tokens
    n_ctx = 997  # prime hash buckets
    table = rng.integers(0, vocab, size=(n_ctx, 4))
    toks = list(rng.integers(0, vocab, size=order))
    mults = rng.integers(1, n_ctx, size=order)
    for _ in range(n_tokens - order):
        h = int(sum(int(toks[-(i + 1)]) * int(mults[i]) for i in range(order)) % n_ctx)
        if rng.random() < 0.85:
            toks.append(int(table[h, rng.integers(0, 4)]))
        else:
            toks.append(int(rng.integers(0, vocab)))
    return np.asarray(toks, dtype=np.int32)
