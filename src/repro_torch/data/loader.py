"""Federated data container + batch iterators (numpy)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.data.synthetic import SyntheticClassificationDataset


@dataclass
class FederatedData:
    """Global dataset + per-client index partition."""

    train: SyntheticClassificationDataset
    test: SyntheticClassificationDataset
    client_indices: List[np.ndarray]

    @property
    def n_clients(self) -> int:
        return len(self.client_indices)

    def client_size(self, k: int) -> int:
        return len(self.client_indices[k])

    def client_batches(self, k: int, batch_size: int, epoch_seed: int
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """One epoch of shuffled batches for client k (drops ragged tail only
        if the client has more than one batch)."""
        idx = self.client_indices[k].copy()
        rng = np.random.default_rng(epoch_seed)
        rng.shuffle(idx)
        if len(idx) <= batch_size:
            yield self.train.x[idx], self.train.y[idx]
            return
        n_full = len(idx) // batch_size
        for i in range(n_full):
            b = idx[i * batch_size:(i + 1) * batch_size]
            yield self.train.x[b], self.train.y[b]

    def label_histogram(self, k: int) -> np.ndarray:
        y = self.train.y[self.client_indices[k]]
        return np.bincount(y, minlength=self.train.n_classes)


def batch_iterator(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled full batches of (x, y), the ragged tail dropped."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(y))
    for i in range(0, len(idx) - batch_size + 1, batch_size):
        b = idx[i:i + batch_size]
        yield x[b], y[b]
