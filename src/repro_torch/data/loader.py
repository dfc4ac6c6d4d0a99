"""Federated data container (numpy)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

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
