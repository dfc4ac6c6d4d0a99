"""Plain PyTorch reference of the benchmark's language models.

What every family shares: the precisions, the products, RMSNorm, RoPE, the
SiLU-gated FFN, the loss, the SGD step and the evaluation.  Each family's
forward (``perfbench/families/<family>.py``) builds its block from these,
written from the published descriptions in float32 with no kernel, cache
or batching beyond the plain products.

Parameters are a nested dict in the layout the port keeps (layers stacked
on a leading axis).  Each leaf is held in its storage dtype and read as
float32: :class:`Precision` says how a leaf is stored and how a product's
input is rounded, which is all the benchmark's control changes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

from perfbench import families

Params = Dict[str, Any]
FP8_MAX = 448.0          # largest float8_e4m3fn value


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the float8_e4m3fn grid under a per-tensor scale (amax maps
    to 448), returned in float32: how an fp8 deployment stores a tensor."""
    x = t.detach().float()
    amax = x.abs().max()
    if float(amax) == 0.0:
        return x
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


@dataclass(frozen=True)
class Precision:
    """How the reference stores its leaves and rounds its products' inputs.

    ``"reference"``: every leaf in its configured dtype (bf16 weights, fp32
    norms and router), products in float32.  ``"fp8"``: the control, one
    precision below the configuration's bf16 -- the bf16 leaves and every
    product's activation input on the fp8 grid, the fp32 leaves as they
    are, and the Q-net in bf16 (one precision below its fp32)."""

    name: str = "reference"

    def store(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        if self.name == "fp8" and dtype != torch.float32:
            return _round_fp8(t)
        return t.to(dtype)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A product's input as the precision feeds it; the gradient passes
        the rounding unchanged."""
        if self.name != "fp8":
            return x
        return x + (_round_fp8(x) - x).detach()

    @property
    def qnet_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.name == "fp8" else torch.float32


REFERENCE = Precision("reference")
CONTROL = Precision("fp8")


def _mm(prec: Precision, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return prec.act(x) @ w.float()


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, Dh): rotate the two halves of each head by position."""
    s, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freqs = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _ffn(prec: Precision, x: torch.Tensor, up, gate, down) -> torch.Tensor:
    return _mm(prec, torch.nn.functional.silu(_mm(prec, x, gate)) * _mm(prec, x, up), down)


def forward(p: Params, cfg: dict, tokens: torch.Tensor, prec: Precision = REFERENCE
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32, aux loss): the forward of
    ``cfg``'s family (``perfbench/families/``)."""
    return families.of(cfg).forward(p, cfg, tokens, prec)


def loss_and_logits(p: Params, cfg: dict, x: torch.Tensor, y: torch.Tensor,
                    prec: Precision = REFERENCE) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token cross-entropy over every position plus the aux loss."""
    logits, aux = forward(p, cfg, x, prec)
    xent = torch.nn.functional.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                             y.reshape(-1).long())
    return xent + aux, logits


def leaves(p: Params, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Every leaf by its ``/``-joined path, keys sorted at each depth."""
    out: Dict[str, torch.Tensor] = {}
    for key in sorted(p):
        v = p[key]
        name = f"{prefix}{key}"
        if isinstance(v, dict):
            out.update(leaves(v, name + "/"))
        else:
            out[name] = v
    return out


def tree_map(fn: Callable, p: Params, *rest: Params) -> Params:
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest))) for k, v in p.items()}


def sgd_step(p: Params, cfg: dict, x: torch.Tensor, y: torch.Tensor, lr: float,
             prec: Precision = REFERENCE) -> Tuple[Params, float]:
    """One SGD step from ``p``: gradients of the fp32 loss, each leaf updated
    in fp32 and stored back in its dtype.  Returns (params, loss at p)."""
    named = leaves(p)
    work = {n: t.float().requires_grad_(True) for n, t in named.items()}
    tree = _unflatten(p, work)
    loss, _ = loss_and_logits(tree, cfg, x, y, prec)
    grads = torch.autograd.grad(loss, list(work.values()))
    new = {n: prec.store(work[n].detach() - lr * g, named[n].dtype)
           for n, g in zip(work, grads)}
    return _unflatten(p, new), float(loss.detach())


def _unflatten(p: Params, flat: Dict[str, torch.Tensor], prefix: str = "") -> Params:
    return {k: (_unflatten(v, flat, f"{prefix}{k}/") if isinstance(v, dict)
                else flat[f"{prefix}{k}"]) for k, v in p.items()}


@torch.no_grad()
def evaluate(p: Params, cfg: dict, x: torch.Tensor, y: torch.Tensor,
             prec: Precision = REFERENCE) -> Tuple[float, float]:
    """(token accuracy, loss) on the test sequences, one call."""
    loss, logits = loss_and_logits(p, cfg, x, y, prec)
    acc = (logits.argmax(-1) == y.long()).float().mean()
    return float(acc), float(loss)


def no_tf32() -> None:
    """Float32 products in float32: TF32 would round their inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
