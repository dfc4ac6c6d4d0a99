"""Client data partitioning: IID and Dirichlet non-IID (paper §4.1 / A.1).

``dirichlet_partition(..., sigma)`` draws per-client label ratios
p_k ~ Dir_N(sigma) (sigma=0.01 for the paper's ID setting, 0.1 for OOD);
small sigma => clients see few classes.  Same RNG stream as the reference.
"""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(n_samples: int, n_clients: int, seed: int = 0,
                  size_skew: float = 0.0) -> List[np.ndarray]:
    """Random split. ``size_skew`` > 0 makes client data volumes lognormal."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_samples)
    if size_skew <= 0:
        return list(np.array_split(idx, n_clients))
    weights = rng.lognormal(0.0, size_skew, size=n_clients)
    weights /= weights.sum()
    counts = np.maximum(8, (weights * n_samples).astype(int))
    counts = np.minimum(counts, n_samples)
    splits, start = [], 0
    for c in counts:
        end = min(start + c, n_samples)
        splits.append(idx[start:end] if end > start else idx[:8])
        start = end
    return splits


def dirichlet_partition(labels: np.ndarray, n_clients: int, sigma: float,
                        seed: int = 0, min_size: int = 8) -> List[np.ndarray]:
    """Label-Dirichlet partition. labels: (N,) int. Returns per-client index
    arrays; every client gets >= min_size samples (tiny clients are topped
    up from the largest one)."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    by_class = [np.where(labels == c)[0] for c in range(n_classes)]
    for c in by_class:
        rng.shuffle(c)

    while True:
        # p[k, c]: client k's share of class c
        p = rng.dirichlet([sigma] * n_clients, size=n_classes)  # (C, K)
        client_idx: List[List[int]] = [[] for _ in range(n_clients)]
        for c, idxs in enumerate(by_class):
            cuts = (np.cumsum(p[c])[:-1] * len(idxs)).astype(int)
            for k, part in enumerate(np.split(idxs, cuts)):
                client_idx[k].extend(part.tolist())
        sizes = np.array([len(ci) for ci in client_idx])
        if sizes.min() >= min_size:
            break
        # top-up tiny clients from the largest (rare at sane sigma)
        donor = int(sizes.argmax())
        for k in range(n_clients):
            need = min_size - sizes[k]
            if need > 0:
                take = client_idx[donor][:need]
                client_idx[donor] = client_idx[donor][need:]
                client_idx[k].extend(take)
        sizes = np.array([len(ci) for ci in client_idx])
        if sizes.min() >= min_size:
            break
    return [np.asarray(sorted(ci), dtype=np.int64) for ci in client_idx]
