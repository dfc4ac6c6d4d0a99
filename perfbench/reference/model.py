"""Plain PyTorch reference of the benchmark's language models.

A llama-style decoder (Yi-6B: RMSNorm, GQA attention with half-split RoPE,
SiLU-gated FFN) and its mixture-of-experts variant (OLMoE-1B-7B: a softmax
router over 64 experts, top 8 with ties to the lowest expert, the gates
renormalised where the configuration says so, a per-call capacity of ``capacity_factor * tokens * k / E``
rounded up to 8 with tokens kept in order, the Switch load-balance and
router-z losses), written from the published descriptions in float32 with
no kernel, cache or batching beyond the plain products.

Parameters are a nested dict in the layout the port keeps (layers stacked
on a leading axis).  Each leaf is held in its storage dtype and read as
float32: :class:`Precision` says how a leaf is stored and how a product's
input is rounded, which is all the benchmark's control changes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch

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


def _attention(cfg: dict, lp: Params, h: torch.Tensor, prec: Precision) -> torch.Tensor:
    b, s, _ = h.shape
    nh, nkv, dh = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = _rope(_mm(prec, h, lp["wq"]).view(b, s, nh, dh), cfg["rope_theta"])
    k = _rope(_mm(prec, h, lp["wk"]).view(b, s, nkv, dh), cfg["rope_theta"])
    v = _mm(prec, h, lp["wv"]).view(b, s, nkv, dh)
    rep = nh // nkv                      # query head i reads key head i // rep
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", prec.act(q), prec.act(k)) / math.sqrt(dh)
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", prec.act(probs), prec.act(v))
    return _mm(prec, out.reshape(b, s, nh * dh), lp["wo"])


def _ffn(prec: Precision, x: torch.Tensor, up, gate, down) -> torch.Tensor:
    return _mm(prec, torch.nn.functional.silu(_mm(prec, x, gate)) * _mm(prec, x, up), down)


def _moe(cfg: dict, mp: Params, h: torch.Tensor, prec: Precision
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer over one call's tokens: (output, aux loss)."""
    moe = cfg["moe"]
    e, k = moe["n_experts"], moe["top_k"]
    b, s, d = h.shape
    t = b * s
    xt = h.reshape(t, d)
    logits = xt @ mp["router"].float()
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = srt[:, :k]
    if moe["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    idx = order[:, :k]                                  # (T, k)
    cap = int(t * k / e * moe["capacity_factor"])
    cap = max(8, (cap + 7) // 8 * 8)
    flat = idx.reshape(-1)                              # token-major order
    onehot = torch.nn.functional.one_hot(flat, e)
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    keep = (pos < cap).reshape(t, k)
    y = torch.zeros_like(xt)
    w = gates * keep
    for ex in range(e):
        tok, slot = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if len(tok) == 0:
            continue
        out = _ffn(prec, xt[tok], mp["up"][ex], mp["gate"][ex], mp["down"][ex])
        y = y.index_add(0, tok, out * w[tok, slot, None])
    me = probs.mean(0)
    ce = onehot.sum(0).float() / (t * k)
    aux = (moe["load_balance_coef"] * e * torch.sum(me * ce)
           + moe["router_z_coef"] * torch.mean(torch.logsumexp(logits, -1) ** 2))
    return y.reshape(b, s, d), aux


def forward(p: Params, cfg: dict, tokens: torch.Tensor, prec: Precision = REFERENCE
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32, the MoE layers' aux loss)."""
    x = p["embed"].float()[tokens.long()]
    aux = torch.zeros((), device=x.device)
    lay = p["layers"]
    for i in range(cfg["n_layers"]):
        lp = {g: {n: v[i] for n, v in lay[g].items()} for g in lay}
        x = x + _attention(cfg, lp["attn"], _rmsnorm(x, lp["norm1"]["scale"], cfg["norm_eps"]), prec)
        h = _rmsnorm(x, lp["norm2"]["scale"], cfg["norm_eps"])
        if "moe" in lp:
            y, a = _moe(cfg, lp["moe"], h, prec)
            aux = aux + a
        else:
            m = lp["mlp"]
            y = _ffn(prec, h, m["up"], m["gate"], m["down"])
        x = x + y
    x = _rmsnorm(x, p["final_norm"]["scale"], cfg["norm_eps"])
    return _mm(prec, x, p["lm_head"]), aux


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
