"""Client-side training tasks: what each FL client trains.

:class:`MLPTask` plays the role of LeNet5/ResNet18 in the paper's testbed on
the synthetic feature datasets; :class:`LMTask` makes a zoo LM the global
model (next-token loss on token sequences, 2-D labels); :class:`ClientTask`
is what the server and the executors need of a task.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Protocol

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import dense_init, softmax_xent

Params = Dict[str, torch.Tensor]


class ClientTask(Protocol):
    def init(self, seed: int = 0, device: DeviceLike = None) -> Params: ...

    def loss(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor: ...

    def accuracy(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor: ...

    def flops_per_sample(self) -> float: ...

    def param_bytes(self) -> float: ...


class MLPTask:
    """2-hidden-layer MLP classifier."""

    def __init__(self, dim: int = 32, hidden: int = 128, n_classes: int = 10):
        self.dim, self.hidden, self.n_classes = dim, hidden, n_classes

    def init(self, seed: int = 0, device: DeviceLike = None) -> Params:
        """Fresh weights from ``torch.Generator().manual_seed(seed)``, placed
        on ``device`` (the card unless ``device="cpu"``)."""
        dev = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        zeros = lambda n: torch.zeros((n,), dtype=torch.float32, device=dev)
        return {
            "w1": dense_init(gen, self.dim, self.hidden, dev),
            "b1": zeros(self.hidden),
            "w2": dense_init(gen, self.hidden, self.hidden, dev),
            "b2": zeros(self.hidden),
            "w3": dense_init(gen, self.hidden, self.n_classes, dev),
            "b3": zeros(self.n_classes),
        }

    def logits(self, p: Params, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ p["w1"] + p["b1"])
        h = torch.relu(h @ p["w2"] + p["b2"])
        return h @ p["w3"] + p["b3"]

    def loss(self, p: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        return softmax_xent(self.logits(p, batch["x"]), batch["y"],
                            batch.get("mask"))

    def accuracy(self, p: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        pred = self.logits(p, batch["x"]).argmax(-1)
        hit = (pred == batch["y"].long()).float()
        mask: Optional[torch.Tensor] = batch.get("mask")
        if mask is None:
            return hit.mean()
        return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def flops_per_sample(self) -> float:
        # fwd+bwd ~= 3x fwd; fwd = 2 * param MACs
        p = self.dim * self.hidden + self.hidden ** 2 + self.hidden * self.n_classes
        return 6.0 * p

    def param_bytes(self) -> float:
        p = (self.dim * self.hidden + self.hidden ** 2
             + self.hidden * self.n_classes + 2 * self.hidden + self.n_classes)
        return 4.0 * p


# ---------------------------------------------------------------------------


class LMTask:
    """Next-token LM on an architecture of the zoo (a reduced or a
    full-width config).  Params are the LM's nested tree; a batch's ``x``
    and ``y`` are (B, S) tokens and next tokens, and the executors' (B,)
    sample mask becomes a per-token loss mask.  Training runs the plain
    ``impl="naive"`` forward, as the reference's FL task does."""

    def __init__(self, cfg: ModelConfig, seq_len: int = 64):
        self.cfg = cfg
        self.seq_len = seq_len

    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
        """Fresh weights from a ``torch.Generator`` seeded with ``seed``
        (:func:`repro_torch.models.transformer.init_params`)."""
        return T.init_params(seed, self.cfg, device)

    @staticmethod
    def _seq_mask(mask: Optional[torch.Tensor], labels: torch.Tensor
                  ) -> Optional[torch.Tensor]:
        """Sample-level (B,) validity -> token-level (B, S) loss mask."""
        if mask is None:
            return None
        return mask[:, None] * torch.ones_like(labels, dtype=torch.float32)

    def loss(self, p, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        loss, _ = T.loss_fn(p, self.cfg, {
            "tokens": batch["x"], "labels": batch["y"],
            "loss_mask": self._seq_mask(batch.get("mask"), batch["y"]),
            "frontend_embeds": batch.get("frontend_embeds"),
        }, impl="naive")
        return loss

    def accuracy(self, p, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        logits, _ = T.forward(p, self.cfg, batch["x"], batch.get("frontend_embeds"))
        hit = (logits.argmax(-1) == batch["y"].long()).float()
        mask = self._seq_mask(batch.get("mask"), batch["y"])
        if mask is None:
            return hit.mean()
        return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    def flops_per_sample(self) -> float:
        return 6.0 * self.cfg.param_count() * self.seq_len

    def param_bytes(self) -> float:
        return 2.0 * self.cfg.param_count()
