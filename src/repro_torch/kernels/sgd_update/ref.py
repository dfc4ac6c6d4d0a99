"""Plain PyTorch version of the one-pass SGD update: the vmapped executor's
update as it was before the kernel, and the op's CPU implementation.

Each leaf steps in fp32 and is cast back to its dtype,
``(a.float() - lr * g.float()).to(a.dtype)``, as the reference's client
step does.  A leaf with more than :data:`STACKED_STEP_CHUNK` elements is
stepped one client at a time into one contiguous output: the same value per
entry, while the fp32 temporaries hold one client's leaf, not the cohort's.
"""
from __future__ import annotations

import torch

# stacked leaves with more elements than this step client by client
STACKED_STEP_CHUNK = 1 << 26


def sgd_leaf_ref(a: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """One SGD update of a leaf in fp32, cast back to the leaf's dtype."""
    return (a.float() - lr * g.float()).to(a.dtype)


def sgd_update_ref(a: torch.Tensor, g: torch.Tensor, lr: float) -> torch.Tensor:
    """:func:`sgd_leaf_ref` over a leaf with a leading client axis, client by
    client past :data:`STACKED_STEP_CHUNK` elements."""
    if a.numel() <= STACKED_STEP_CHUNK:
        return sgd_leaf_ref(a, g, lr)
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    for j in range(a.shape[0]):
        out[j] = sgd_leaf_ref(a[j], g[j], lr)
    return out
