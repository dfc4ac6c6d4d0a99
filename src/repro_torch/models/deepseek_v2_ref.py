"""Plain reference of DeepSeek-V2-Lite's forward, loss and aux loss.

Written from the paper (arXiv:2405.04434, section 2) and the
``modeling_deepseek.py`` published beside the model's config, in plain
PyTorch and float32: no kernel, no cache, no batching beyond the plain
products, a loop over the held experts.  It imports nothing of the port,
so a test can hold :mod:`repro_torch.models.transformer` to it.
:func:`forward` switches TF32 off (:func:`no_tf32`) before any product.

``cfg`` is a dict of the sizes (:func:`dims_of` makes it from the port's
config); ``p`` the port's parameter tree (``embed``, ``dense_layers``,
``layers``, ``final_norm``, ``lm_head``; layers stacked on a leading axis,
``(in, out)`` matrices), read as float32.

* MLA: ``q = x Wq`` split into ``q_nope`` and ``q_pe``; ``[c_kv, k_pe] = x
  Wkv_a``; ``c_kv = RMSNorm(c_kv)``; ``[k_nope, v] = c_kv Wkv_b``; YaRN RoPE
  on ``q_pe`` and the one shared ``k_pe``; ``score = [q_nope, q_pe].[k_nope,
  k_pe] x (nope + rope)^-0.5 x m^2``; causal softmax; ``out Wo``.
* YaRN: ``inv = inter (1 - mask) + extra mask`` with ``extra = theta^(-2i /
  dim)``, ``inter = 1 / (factor theta^(2i / dim))``, ``mask = 1 - ramp`` over
  the correction range of ``beta_fast`` and ``beta_slow``; cos and sin
  times ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``.
* The dense layers: a SwiGLU FFN.  The expert layers: softmax over all
  experts in fp32, the top k (ties to the lowest index), gates not
  renormalised (the published ``routed_scaling_factor`` is 1);
  capacity ``max(8, ceil8(int(T k / E x factor)))`` per expert with pairs
  kept in token-major order (the port's deployable dispatch; the published
  code is dropless); the routed output summed over the held experts only,
  plus the shared experts' SwiGLU; the balance loss ``alpha x mean over
  sequences of sum_e f_e P_e``, ``f_e = E / (k S) x`` the sequence's choices
  of e, ``P_e`` its mean probability of e; no router z-loss.

Departures from the published code, shared with the port: RoPE rotates the
half-split layout (the checkpoint's interleaved columns are a fixed
permutation, immaterial with random weights), and the expert capacity above.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    """Float32 products in float32: TF32 would round their inputs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def dims_of(cfg) -> Dict:
    """The sizes this reference reads, from the port's ``MLAConfig``; one
    whose gates, balance loss or shared experts are not the published
    model's is refused."""
    moe = cfg.moe
    if moe.norm_topk_prob or not moe.seq_aux or not moe.n_shared_experts:
        raise ValueError("the reference computes DeepSeek-V2-Lite's expert layer: "
                         "unrenormalised gates, the sequence-level loss, shared experts")
    return {"n_layers": cfg.n_layers, "first_k_dense": cfg.first_k_dense,
            "n_heads": cfg.n_heads, "kv_lora_rank": cfg.kv_lora_rank,
            "nope": cfg.qk_nope_head_dim, "rope": cfg.qk_rope_head_dim, "v": cfg.v_head_dim,
            "theta": cfg.rope_theta, "factor": cfg.rope_factor,
            "original_max_pos": cfg.rope_original_max_pos, "beta_fast": cfg.rope_beta_fast,
            "beta_slow": cfg.rope_beta_slow, "mscale": cfg.rope_mscale,
            "mscale_all_dim": cfg.rope_mscale_all_dim, "eps": 1e-6,
            "n_experts": moe.n_experts, "top_k": moe.top_k,
            "held": moe.experts_held or moe.n_experts, "offset": moe.expert_offset,
            "capacity_factor": moe.capacity_factor, "alpha": moe.load_balance_coef}


def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def _swiglu(x: torch.Tensor, m: Dict) -> torch.Tensor:
    return (F.silu(x @ m["gate"].float()) * (x @ m["up"].float())) @ m["down"].float()


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def yarn(cfg: Dict, seq: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (S, rope/2), of YaRN's frequencies."""
    dim, base, factor = cfg["rope"], cfg["theta"], cfg["factor"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (factor * base ** exps)

    def corr(rot):
        return dim * math.log(cfg["original_max_pos"] / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(cfg["beta_fast"])), 0)
    high = min(math.ceil(corr(cfg["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv = inter * (1 - mask) + extra * mask
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    m = _mscale(factor, cfg["mscale"]) / _mscale(factor, cfg["mscale_all_dim"])
    return torch.cos(ang) * m, torch.sin(ang) * m


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D): rotate the two halves of each head."""
    half = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def softmax_scale(cfg: Dict) -> float:
    m = _mscale(cfg["factor"], cfg["mscale_all_dim"]) if cfg["mscale_all_dim"] else 1.0
    return (cfg["nope"] + cfg["rope"]) ** -0.5 * m * m


def mla(cfg: Dict, a: Dict, x: torch.Tensor) -> torch.Tensor:
    """One MLA block over the normed input x (B, S, d), fp32."""
    b, s, _ = x.shape
    h, r, nope, rope, vd = cfg["n_heads"], cfg["kv_lora_rank"], cfg["nope"], cfg["rope"], cfg["v"]
    q = (x @ a["wq"].float()).view(b, s, h, nope + rope)
    kv_a = x @ a["wkv_a"].float()
    c_kv = _rmsnorm(kv_a[..., :r], a["kv_norm"]["scale"], cfg["eps"])
    kv = (c_kv @ a["wkv_b"].float()).view(b, s, h, nope + vd)
    cos, sin = yarn(cfg, s, x.device)
    q_pe = _rope(q[..., nope:], cos, sin)
    k_pe = _rope(kv_a[..., r:].view(b, s, 1, rope), cos, sin).expand(b, s, h, rope)
    qq = torch.cat([q[..., :nope], q_pe], dim=-1)
    kk = torch.cat([kv[..., :nope], k_pe], dim=-1)
    scores = torch.einsum("bqhd,bkhd->bhqk", qq, kk) * softmax_scale(cfg)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, kv[..., nope:])
    return out.reshape(b, s, h * vd) @ a["wo"].float()


def capacity(tokens: int, cfg: Dict) -> int:
    cap = int(tokens * cfg["top_k"] / cfg["n_experts"] * cfg["capacity_factor"])
    return max(8, (cap + 7) // 8 * 8)


def moe(cfg: Dict, m: Dict, h: torch.Tensor, routed: bool = True, shared: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One expert layer over the normed input h (B, S, d): (output, aux).
    ``routed`` / ``shared`` leave out the held routed experts' part or the
    shared experts' (the expert-share test sums the parts)."""
    e, k = cfg["n_experts"], cfg["top_k"]
    b, s, d = h.shape
    t = b * s
    xt = h.reshape(t, d)
    probs = torch.softmax(xt @ m["router"].float(), dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt[:, :k], order[:, :k]
    onehot = F.one_hot(idx.reshape(-1), e)                    # token-major pairs
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    keep = (pos < capacity(t, cfg)).reshape(t, k)
    y = torch.zeros_like(xt)
    if routed:
        for j in range(cfg["held"]):
            tok, slot = torch.nonzero((idx == cfg["offset"] + j) & keep, as_tuple=True)
            if len(tok) == 0:
                continue
            ex = {n: m[n][j] for n in ("up", "gate", "down")}
            y = y.index_add(0, tok, _swiglu(xt[tok], ex) * gates[tok, slot, None])
    if shared:
        y = y + _swiglu(xt, m["shared"])
    f = onehot.reshape(b, s * k, e).sum(1).float() * (e / (s * k))
    aux = cfg["alpha"] * (f * probs.reshape(b, s, e).mean(1)).sum(-1).mean()
    return y.reshape(b, s, d), aux


def _layer(tree: Dict, i: int) -> Dict:
    """Layer ``i`` of a stacked group."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def forward(p: Dict, cfg: Dict, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32, the expert layers' aux)."""
    no_tf32()
    x = p["embed"].float()[tokens.long()]
    aux = torch.zeros((), device=x.device)
    stacks = [(p["dense_layers"], cfg["first_k_dense"]),
              (p["layers"], cfg["n_layers"] - cfg["first_k_dense"])]
    for lay, n in stacks:
        for i in range(n):
            lp = _layer(lay, i)
            x = x + mla(cfg, lp["attn"], _rmsnorm(x, lp["norm1"]["scale"], cfg["eps"]))
            hh = _rmsnorm(x, lp["norm2"]["scale"], cfg["eps"])
            if "moe" in lp:
                y, a = moe(cfg, lp["moe"], hh)
                aux = aux + a
            else:
                y = _swiglu(hh, lp["mlp"])
            x = x + y
    x = _rmsnorm(x, p["final_norm"]["scale"], cfg["eps"])
    return x @ p["lm_head"].float(), aux


def loss(p: Dict, cfg: Dict, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy plus the aux loss."""
    logits, aux = forward(p, cfg, tokens)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long()) + aux
