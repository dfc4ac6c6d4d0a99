"""Plain PyTorch version of fused Q-net scoring + top-K cohort selection.

Score every candidate with the 3-layer Q-net MLP (``@`` products), add the
per-candidate ``bias``, sink masked rows to ``NEG_INF``, then cut the cohort
with a stable descending sort.  This is the semantics the CUDA kernel
(:mod:`repro_torch.kernels.select_topk.kernel`) is held to:

* masked candidates (``mask == 0``) score ``NEG_INF`` and are selected only
  once every valid candidate is taken (``k > n_valid``);
* equal scores break toward the LOWEST candidate index — a stable sort keeps
  equal keys in index order (``torch.topk`` promises no order for ties);
* ``bias`` is applied after the MLP (selection-side terms outside the
  learned net, e.g. FedRank's over-participation fairness decay).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

# Large negative fp32 sentinel for masked candidates.  Not -inf: arithmetic on
# the sentinel stays finite.
NEG_INF = -3.0e38


def qnet_scores_ref(params: Dict[str, torch.Tensor],
                    feats: torch.Tensor) -> torch.Tensor:
    """feats (N, F) -> scores (N,): the Q-net MLP head."""
    f = feats.float()
    h = torch.relu(f @ params["w1"] + params["b1"])
    h = torch.relu(h @ params["w2"] + params["b2"])
    return (h @ params["w3"].reshape(-1, 1) + params["b3"])[..., 0]


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, descending,
    equal scores in ascending index order."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk_ref(params: Dict[str, torch.Tensor], feats: torch.Tensor,
                    mask: torch.Tensor, bias: torch.Tensor, *, k: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """feats (N, F), mask (N,), bias (N,) -> (values (k,) f32, indices (k,)
    int64); k must be <= N."""
    s = qnet_scores_ref(params, feats) + bias.float()
    s = torch.where(mask > 0, s, torch.full_like(s, NEG_INF))
    return stable_topk(s, k)
