"""The deepseek_v2 family: DeepSeek-V2-Lite (arXiv:2405.04434; the
``config.json`` and ``modeling_deepseek.py`` published on its Hugging Face
page).  Multi-head latent attention in every layer; ``first_k_dense_replace``
dense SwiGLU layers of ``intermediate_size``, then expert layers: a softmax
router over ``n_routed_experts_published`` experts in fp32, the top
``num_experts_per_tok`` (ties to the lowest expert), gates not renormalised
(``norm_topk_prob`` false, ``routed_scaling_factor`` 1: :func:`dims` refuses
a file with other values), the held experts' SwiGLUs of ``moe_intermediate_size`` with a capacity per
expert of the whole layer, ``n_shared_experts`` shared experts as one SwiGLU
of their summed width, and the sequence-level balance loss ``alpha x mean
over sequences of sum_e f_e P_e``; no router z-loss.

MLA: ``q = x Wq`` (no low-rank query) split into ``q_nope`` and ``q_pe``;
``[c_kv, k_pe] = x Wkv_a``; ``c_kv = RMSNorm(c_kv)``; ``[k_nope, v] = c_kv
Wkv_b``; YaRN RoPE on ``q_pe`` and the one ``k_pe`` that every head shares;
``score = [q_nope, q_pe].[k_nope, k_pe] x (nope + rope)^-0.5 x m^2`` with
``m = 0.1 mscale_all_dim ln(factor) + 1``; causal softmax; ``out Wo``.

The layer holds ``n_routed_experts`` of the router's experts, from
``expert_offset``: one card's share where the layer is divided over cards
by expert parallelism.  It routes over all of them and computes its own
experts' part of the result; the reference does the same.

The reference here is written from the published descriptions in float32
with no kernel, cache or batching beyond the plain products, a loop over
the held experts.  Shared with the port: RoPE rotates the half-split layout
(the checkpoint's interleaved columns are a fixed permutation, immaterial
with random weights), and the capacity drop with tokens kept in order (the
published code is dropless).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from perfbench.reference.model import REFERENCE, Params, Precision, _ffn, _mm, _rmsnorm
from perfbench.weights import DTYPES, _dense, _normal

# the configuration file's published key -> the name the harness uses
PUBLISHED = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads", "kv_lora_rank": "kv_lora_rank",
             "qk_nope_head_dim": "qk_nope_head_dim", "qk_rope_head_dim": "qk_rope_head_dim",
             "v_head_dim": "v_head_dim", "intermediate_size": "d_ff_dense",
             "first_k_dense_replace": "first_k_dense", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps"}
ROPE_SCALING = {"factor": "rope_factor", "original_max_position_embeddings":
                "rope_original_max_pos", "beta_fast": "rope_beta_fast",
                "beta_slow": "rope_beta_slow", "mscale": "rope_mscale",
                "mscale_all_dim": "rope_mscale_all_dim"}
PORT_KEYS = ("n_layers", "d_model", "n_heads", "kv_lora_rank", "qk_nope_head_dim",
             "qk_rope_head_dim", "v_head_dim", "d_ff_dense", "first_k_dense", "vocab_size",
             "rope_theta", "dtype", "remat", *ROPE_SCALING.values())


def dims(raw: dict) -> dict:
    """The sizes under the harness's names, the YaRN settings, and the
    expert layer's: ``n_experts`` the router's count, ``held`` the experts
    this card holds (``n_routed_experts``) from ``offset``.  Refuses gates
    or a balance loss that the reference does not compute."""
    if (raw["norm_topk_prob"] or raw["routed_scaling_factor"] != 1 or not raw["seq_aux"]
            or raw["topk_method"] != "greedy"):
        raise ValueError(f"{raw['name']}: the deepseek_v2 family computes unrenormalised "
                         "greedy top-k gates at scale 1 and the sequence-level balance loss")
    conf = {PUBLISHED[k]: v for k, v in raw.items() if k in PUBLISHED}
    conf.update({ROPE_SCALING[k]: v for k, v in raw["rope_scaling"].items() if k in ROPE_SCALING})
    conf.update(name=raw["name"], model=raw["model"], dtype=raw["dtype"], remat=raw["remat"])
    conf["moe"] = {"n_experts": raw["n_routed_experts_published"],
                   "held": raw["n_routed_experts"], "offset": raw["expert_offset"],
                   "top_k": raw["num_experts_per_tok"], "d_ff_expert": raw["moe_intermediate_size"],
                   "n_shared": raw["n_shared_experts"], "alpha": raw["aux_loss_alpha"], "capacity_factor": raw["capacity_factor"]}
    return conf


def port_fields(conf: dict, base) -> dict:
    """Every size the file states, over the registry entry ``base`` (an
    ``MLAConfig``)."""
    import dataclasses

    m = conf["moe"]
    fields = {k: conf[k] for k in PORT_KEYS}
    fields.update(n_kv_heads=conf["n_heads"], d_ff=m["d_ff_expert"],
                  head_dim=conf["qk_nope_head_dim"] + conf["qk_rope_head_dim"])
    fields["moe"] = dataclasses.replace(
        base.moe, n_experts=m["n_experts"], top_k=m["top_k"], d_ff_expert=m["d_ff_expert"],
        capacity_factor=m["capacity_factor"], load_balance_coef=m["alpha"], router_z_coef=0.0,
        n_shared_experts=m["n_shared"], norm_topk_prob=False, seq_aux=True,
        experts_held=m["held"], expert_offset=m["offset"])
    return fields


def weights(conf: dict, gen: torch.Generator, device) -> Dict:
    """Embedding, ``dense_layers`` (norms, MLA, a dense ``mlp``) and
    ``layers`` (norms, MLA, a ``moe`` group with its ``shared`` experts),
    each stacked over its own layers, the final norm and the head; drawn in
    that order."""
    dt = DTYPES[conf["dtype"]]
    d, v, n_dense = conf["d_model"], conf["vocab_size"], conf["first_k_dense"]
    h, r = conf["n_heads"], conf["kv_lora_rank"]
    nope, rope, vd = conf["qk_nope_head_dim"], conf["qk_rope_head_dim"], conf["v_head_dim"]
    m = conf["moe"]
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)

    def stack(n: int, ffn) -> Dict:
        attn = {"wq": _dense(gen, (n, d, h * (nope + rope)), d, dt),
                "wkv_a": _dense(gen, (n, d, r + rope), d, dt),
                "kv_norm": {"scale": ones(n, r)},
                "wkv_b": _dense(gen, (n, r, h * (nope + vd)), r, dt),
                "wo": _dense(gen, (n, h * vd, d), h * vd, dt)}
        return {"norm1": {"scale": ones(n, d)}, "norm2": {"scale": ones(n, d)}, "attn": attn,
                **ffn(n)}

    def mlp(lead, f):
        return {"up": _dense(gen, lead + (d, f), d, dt), "gate": _dense(gen, lead + (d, f), d, dt),
                "down": _dense(gen, lead + (f, d), f, dt)}

    embed = _normal(gen, (v, d), 0.02, dt)
    dense = stack(n_dense, lambda n: {"mlp": mlp((n,), conf["d_ff_dense"])})
    experts = stack(conf["n_layers"] - n_dense, lambda n: {"moe": {
        "router": _dense(gen, (n, d, m["n_experts"]), d, torch.float32),
        **mlp((n, m["held"]), m["d_ff_expert"]),
        "shared": mlp((n,), m["n_shared"] * m["d_ff_expert"])}})
    return {"embed": embed, "dense_layers": dense, "layers": experts,
            "final_norm": {"scale": ones(d)}, "lm_head": _normal(gen, (d, v), 0.02, dt)}


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def _yarn(cfg: dict, seq: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (S, rope/2) of YaRN's frequencies: ``inter (1 - mask) +
    extra mask``, ``mask = 1 - ramp`` over the correction range."""
    dim, base, factor = cfg["qk_rope_head_dim"], cfg["rope_theta"], cfg["rope_factor"]
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** exps)
    inter = 1.0 / (factor * base ** exps)

    def corr(rot):
        return (dim * math.log(cfg["rope_original_max_pos"] / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(cfg["rope_beta_fast"])), 0)
    high = min(math.ceil(corr(cfg["rope_beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv = inter * (1 - mask) + extra * mask
    ang = torch.arange(seq, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    ms = _mscale(factor, cfg["rope_mscale"]) / _mscale(factor, cfg["rope_mscale_all_dim"])
    return torch.cos(ang) * ms, torch.sin(ang) * ms


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _mla(cfg: dict, a: Params, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    b, s, _ = x.shape
    h, r = cfg["n_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = _mm(prec, x, a["wq"]).view(b, s, h, nope + rope)
    kv_a = _mm(prec, x, a["wkv_a"])
    c_kv = _rmsnorm(kv_a[..., :r], a["kv_norm"]["scale"], cfg["norm_eps"])
    kv = _mm(prec, c_kv, a["wkv_b"]).view(b, s, h, nope + vd)
    cos, sin = _yarn(cfg, s, x.device)
    q_pe = _rotate(q[..., nope:], cos, sin)
    k_pe = _rotate(kv_a[..., r:].view(b, s, 1, rope), cos, sin).expand(b, s, h, rope)
    qq = torch.cat([q[..., :nope], q_pe], dim=-1)
    kk = torch.cat([kv[..., :nope], k_pe], dim=-1)
    m = _mscale(cfg["rope_factor"], cfg["rope_mscale_all_dim"]) if cfg["rope_mscale_all_dim"] else 1.0
    scores = (torch.einsum("bqhd,bkhd->bhqk", prec.act(qq), prec.act(kk))
              * (nope + rope) ** -0.5 * m * m)
    causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", prec.act(probs), prec.act(kv[..., nope:]))
    return _mm(prec, out.reshape(b, s, h * vd), a["wo"])


def _moe(cfg: dict, mp: Params, h: torch.Tensor, prec: Precision
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer over one call's tokens: (output, aux loss)."""
    m = cfg["moe"]
    e, k = m["n_experts"], m["top_k"]
    b, s, d = h.shape
    t = b * s
    xt = h.reshape(t, d)
    probs = torch.softmax(xt @ mp["router"].float(), dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = srt[:, :k], order[:, :k]
    cap = int(t * k / e * m["capacity_factor"])
    cap = max(8, (cap + 7) // 8 * 8)
    onehot = torch.nn.functional.one_hot(idx.reshape(-1), e)        # token-major pairs
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    keep = (pos < cap).reshape(t, k)
    y = torch.zeros_like(xt)
    for j in range(m["held"]):
        tok, slot = torch.nonzero((idx == m["offset"] + j) & keep, as_tuple=True)
        if len(tok) == 0:
            continue
        out = _ffn(prec, xt[tok], mp["up"][j], mp["gate"][j], mp["down"][j])
        y = y.index_add(0, tok, out * gates[tok, slot, None])
    sh = mp["shared"]
    y = y + _ffn(prec, xt, sh["up"], sh["gate"], sh["down"])
    f = onehot.reshape(b, s * k, e).sum(1).float() * (e / (s * k))
    aux = m["alpha"] * (f * probs.reshape(b, s, e).mean(1)).sum(-1).mean()
    return y.reshape(b, s, d), aux


def _layer(tree: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def forward(p: Params, cfg: dict, tokens: torch.Tensor, prec: Precision = REFERENCE
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (logits (B, S, V) fp32, the expert layers' aux loss)."""
    x = p["embed"].float()[tokens.long()]
    aux = torch.zeros((), device=x.device)
    n_dense = cfg["first_k_dense"]
    for lay, n in ((p["dense_layers"], n_dense), (p["layers"], cfg["n_layers"] - n_dense)):
        for i in range(n):
            lp = _layer(lay, i)
            x = x + _mla(cfg, lp["attn"], _rmsnorm(x, lp["norm1"]["scale"], cfg["norm_eps"]), prec)
            hh = _rmsnorm(x, lp["norm2"]["scale"], cfg["norm_eps"])
            if "moe" in lp:
                y, a = _moe(cfg, lp["moe"], hh, prec)
                aux = aux + a
            else:
                mlp = lp["mlp"]
                y = _ffn(prec, hh, mlp["up"], mlp["gate"], mlp["down"])
            x = x + y
    x = _rmsnorm(x, p["final_norm"]["scale"], cfg["norm_eps"])
    return _mm(prec, x, p["lm_head"]), aux


def mla_matmul_params(cfg: dict) -> int:
    """MLA's four matrices, a token's products in one layer."""
    d, h, r = cfg["d_model"], cfg["n_heads"], cfg["kv_lora_rank"]
    nope, rope, vd = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return d * h * (nope + rope) + d * (r + rope) + r * h * (nope + vd) + h * vd * d


def matmul_params(cfg: dict) -> float:
    """Matrix parameters a token passes through on this card: MLA in every
    layer, the dense FFN in the dense layers, and in each expert layer the
    router, the shared experts and ``top_k x held / n_experts`` routed
    experts (the expected share of a token's experts held here); the output
    head (the embedding is a lookup)."""
    d, m = cfg["d_model"], cfg["moe"]
    n_dense = cfg["first_k_dense"]
    expert = 3 * d * m["d_ff_expert"]
    moe_layer = (d * m["n_experts"] + m["n_shared"] * expert
                 + m["top_k"] * m["held"] / m["n_experts"] * expert)
    return (cfg["n_layers"] * mla_matmul_params(cfg) + n_dense * 3 * d * cfg["d_ff_dense"]
            + (cfg["n_layers"] - n_dense) * moe_layer + d * cfg["vocab_size"])


def attention_flops(cfg: dict, seq: int) -> float:
    """Forward causal attention products of one sequence over all layers:
    S(S+1) x (q.k width + v width) x heads a layer."""
    width = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]
    return float(seq * (seq + 1) * width * cfg["n_heads"] * cfg["n_layers"])


def smoke(conf: dict, dtype: str) -> dict:
    """Every width cut to the CPU tests' size, one dense and two expert
    layers, 4 of 16 experts held from expert 4; MLA, YaRN, the shared
    experts and the gates as published."""
    conf = dict(conf, n_layers=3, d_model=32, n_heads=4, kv_lora_rank=16, qk_nope_head_dim=8,
                qk_rope_head_dim=4, v_head_dim=8, d_ff_dense=64, vocab_size=128, dtype=dtype)
    conf["moe"] = dict(conf["moe"], n_experts=16, held=4, offset=4, top_k=2, d_ff_expert=16)
    return conf
