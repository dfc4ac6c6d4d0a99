"""Neural-net layers in PyTorch: the FL tasks' and the Q-net's, and the LM
zoo's norms, RoPE, MLPs and embeddings.

Parameters are plain dicts of tensors in the reference's layout (``w`` shaped
``(in, out)``).  :func:`dense_init` (FL tasks, Q-net) draws from a
``torch.Generator`` on the CPU and then moves the tensor, so one seed gives
the same weights on every device.  The LM initializers
(:func:`dense_init_on`, :func:`normal_on`, :func:`embed_init`,
:func:`init_mlp`) draw on the
generator's own device instead: at Yi-6B's 6.06B parameters a host draw
would take tens of GB and minutes.  The reference's ``jax.random`` streams
give other numbers; parity tests carry its weights across with
:mod:`repro_torch.convert`.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor

Params = Dict[str, torch.Tensor]


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               device: torch.device) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun): N(0, 1) cut at +-2, times
    1/sqrt(d_in) — the reference's ``dense_init`` distribution."""
    w = torch.empty((d_in, d_out), dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w / math.sqrt(d_in)).to(device)


# ---------------------------------------------------------------------------
# LM initializers: drawn on the generator's device, ``lead`` stacked layers
# ---------------------------------------------------------------------------


def _fill(gen: torch.Generator, shape: Tuple[int, ...], dtype: torch.dtype,
          lead: Tuple[int, ...], draw: Callable[[torch.Tensor], None]) -> torch.Tensor:
    """A ``lead + shape`` tensor of ``dtype``, each ``shape`` slice drawn in
    fp32 by ``draw`` on ``gen``'s device (one slice of fp32 scratch)."""
    out = torch.empty(lead + shape, dtype=dtype, device=gen.device)
    if is_fake(out):                  # a shape stand-in (launch/steps.py): no draws
        return out
    flat = out.view(-1, *shape)
    tmp = torch.empty(shape, dtype=torch.float32, device=gen.device)
    for i in range(flat.shape[0]):
        draw(tmp)
        flat[i].copy_(tmp)
    return out


def dense_init_on(gen: torch.Generator, d_in: int, d_out: int, dtype: torch.dtype,
                  lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """The reference's ``dense_init`` distribution (N(0, 1) cut at +-2, times
    1/sqrt(d_in)), drawn on ``gen``'s device; shape ``lead + (d_in, d_out)``."""
    std = 1.0 / math.sqrt(d_in)

    def draw(t):
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        t.mul_(std)

    return _fill(gen, (d_in, d_out), dtype, lead, draw)


def normal_on(gen: torch.Generator, shape: Tuple[int, ...], std: float,
              dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, std²) entries, drawn on ``gen``'s device; shape ``lead + shape``."""
    return _fill(gen, shape, dtype, lead, lambda t: t.normal_(0.0, std, generator=gen))


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """N(0, 0.02²) embedding table ``(vocab, d)``, on ``gen``'s device."""
    return normal_on(gen, (vocab, d), 0.02, dtype, lead)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(kind: str, d: int, dtype: torch.dtype, device: torch.device,
              lead: Tuple[int, ...] = ()) -> Params:
    if kind == "rmsnorm":
        return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
                "bias": torch.zeros(lead + (d,), dtype=dtype, device=device)}
    raise ValueError(kind)


def apply_norm(kind: str, p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Norms with fp32 *statistics* but input-dtype tensor math, as the
    reference's: the sums are fp32, the scaling is in ``x``'s dtype."""
    d = x.shape[-1]
    xf = x.float()
    if kind == "rmsnorm":
        sq = (xf * xf).sum(-1, keepdim=True)
        inv = torch.rsqrt(sq / d + eps).to(x.dtype)
        return x * inv * p["scale"].to(x.dtype)
    if kind == "layernorm":
        s1 = xf.sum(-1, keepdim=True)
        s2 = (xf * xf).sum(-1, keepdim=True)
        mu = s1 / d
        var = torch.clamp(s2 / d - mu * mu, min=0.0)
        inv = torch.rsqrt(var + eps)
        y = (x - mu.to(x.dtype)) * inv.to(x.dtype)
        return y * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def activation_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name in ("silu", "geglu"):  # gate nonlinearity; geglu gates with gelu
        return F.silu if name == "silu" else _gelu
    if name == "gelu":
        return _gelu
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


def is_gated(name: str) -> bool:
    return name in ("silu", "geglu")


# ---------------------------------------------------------------------------
# Dense FFN (gated or plain)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, activation: str,
             dtype: torch.dtype, lead: Tuple[int, ...] = ()) -> Params:
    p = {"up": dense_init_on(gen, d_model, d_ff, dtype, lead),
         "down": dense_init_on(gen, d_ff, d_model, dtype, lead)}
    if is_gated(activation):
        p["gate"] = dense_init_on(gen, d_model, d_ff, dtype, lead)
    return p


def apply_mlp(p: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    act = activation_fn(activation)
    up = x @ p["up"]
    if is_gated(activation):
        up = act(x @ p["gate"]) * up
    else:
        up = act(up)
    return up @ p["down"]


# ---------------------------------------------------------------------------
# Rotary and sinusoidal positions
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).  Half-split
    rotation, angles and products in fp32, the result in ``x``'s dtype."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)                 # (half,)
    angles = positions[..., :, None].float() * freqs                 # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                            # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def _sin_div(d: int, device: Optional[torch.device]) -> torch.Tensor:
    return torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / d))


def sinusoidal_positions(max_len: int, d: int,
                         device: Optional[torch.device] = None) -> torch.Tensor:
    """Whisper-style sinusoidal position table (max_len, d)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = _sin_div(d, device)
    tab = torch.zeros((max_len, d), dtype=torch.float32, device=device)
    tab[:, 0::2] = torch.sin(pos * div)
    tab[:, 1::2] = torch.cos(pos * div)
    return tab


def sinusoidal_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position vectors ``pos.shape + (d,)`` at a tensor of
    positions: (d,) at a scalar, (B, d) at a (B,) batch of positions (the
    reference's ``jax.vmap(sinusoidal_at, (0, None))``)."""
    ang = pos.float()[..., None] * _sin_div(d, pos.device)
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(pos.shape + (d,))


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def _vocab_ids(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[-1], device=x.device)


class _Xent(torch.autograd.Function):
    """Masked mean cross-entropy with the reference's memory-lean VJP
    (``_xent_vjp_fwd``/``_bwd``).  The forward's statistics are fp32; the
    residuals are the logits in their own dtype, the labels, ``logz``, the
    mask and its clamped sum.  Autograd's own backward of the fp32 math
    would keep an fp32 copy of the whole (..., V) logits instead.  The
    gradient, ``(softmax - onehot) * g * m / denom`` in the logits' dtype,
    is formed in the order autograd of that math takes (``s * softmax``,
    then ``- s`` at the label, ``s = g / denom * m``), so fp32 logits get
    the same bits as from autograd (the reference's order differs by an
    ulp at the label).  Works under ``torch.func`` transforms
    (``generate_vmap_rule``), as the vmapped FL executor needs."""

    generate_vmap_rule = True

    @staticmethod
    def forward(logits, labels, m):
        lf = logits.float()
        logz = torch.logsumexp(lf, dim=-1)
        if isinstance(lf, DTensor):
            # the reference's where/iota lookup: it partitions over a sharded
            # vocab (a gather there leaves a masked partial DTensor cannot
            # reshape); one nonzero term a row, so the same value
            gold = torch.where(_vocab_ids(lf) == labels.long().unsqueeze(-1), lf, 0.0).sum(-1)
        else:
            gold = lf.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
        denom = torch.clamp(m.sum(), min=1.0)
        return ((logz - gold) * m).sum() / denom, logz, denom

    @staticmethod
    def setup_context(ctx, inputs, output):
        logits, labels, m = inputs
        _, logz, denom = output
        ctx.mark_non_differentiable(logz, denom)
        ctx.save_for_backward(logits, labels, logz, m, denom)

    @staticmethod
    def backward(ctx, g, _glogz, _gdenom):
        logits, labels, logz, m, denom = ctx.saved_tensors
        s = (g / denom * m).unsqueeze(-1)
        dl = torch.exp(logits.float() - logz.unsqueeze(-1))           # softmax
        dl.mul_(s)
        if isinstance(dl, DTensor):                                   # x - s == x + (-s)
            dl = dl - torch.where(_vocab_ids(dl) == labels.long().unsqueeze(-1), s, 0.0)
        else:
            dl.scatter_add_(-1, labels.long().unsqueeze(-1), -s)      # - onehot * s
        return dl.to(logits.dtype), None, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over valid positions. logits (..., V), labels (...);
    fp32 statistics, the gradient in the logits' dtype (:class:`_Xent`)."""
    m = (torch.ones(labels.shape, dtype=torch.float32, device=logits.device)
         if mask is None else mask.float())
    return _Xent.apply(logits, labels, m)[0]
