"""The decoder family: a llama-style decoder (Yi-6B: RMSNorm, GQA attention
with half-split RoPE, SiLU-gated FFN) and its mixture-of-experts variant
(OLMoE-1B-7B: a softmax router over 64 experts, top 8 with ties to the
lowest expert, the gates renormalised where the configuration says so, a
per-call capacity of ``capacity_factor * tokens * k / E`` rounded up to 8
with tokens kept in order, the Switch load-balance and router-z losses).
Every layer is alike: attention, then the FFN or, where the file gives
``num_experts``, the expert layer with the FFN's width.

The reference here is written from the published descriptions in float32
with no kernel, cache or batching beyond the plain products.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from perfbench.reference.model import REFERENCE, Params, Precision, _ffn, _mm, _rmsnorm, _rope
from perfbench.weights import DTYPES, _dense, _normal

MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "rope_theta", "dtype", "remat")
# the configuration files' published key -> the name the harness uses
PUBLISHED = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
             "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab_size",
             "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps"}
MOE_KEYS = {"num_experts": "n_experts", "num_experts_per_tok": "top_k",
            "router_aux_loss_coef": "load_balance_coef", "router_z_loss_coef": "router_z_coef",
            "capacity_factor": "capacity_factor", "norm_topk_prob": "norm_topk_prob"}


def dims(raw: dict) -> dict:
    """The sizes under their published keys, ``model`` (the port's registry
    name), ``dtype``, ``remat``, and for an expert model the router's
    settings."""
    conf = {PUBLISHED[k]: v for k, v in raw.items() if k in PUBLISHED}
    conf.update(name=raw["name"], model=raw["model"], dtype=raw["dtype"], remat=raw["remat"])
    if "num_experts" in raw:
        conf["moe"] = {v: raw[k] for k, v in MOE_KEYS.items()}
        conf["moe"]["d_ff_expert"] = conf["d_ff"]
    return conf


def port_fields(conf: dict, base) -> dict:
    """Every size the file states, over the registry entry ``base``."""
    fields = {k: conf[k] for k in MODEL_KEYS if k in conf}
    if conf.get("moe"):
        moe_keys = {f.name for f in dataclasses.fields(base.moe)}
        fields["moe"] = dataclasses.replace(
            base.moe, **{k: v for k, v in conf["moe"].items() if k in moe_keys})
    return fields


def weights(conf: dict, gen: torch.Generator, device) -> Dict:
    """Embedding, the stacked layers (norms, ``wq``/``wk``/``wv``/``wo``, an
    ``mlp`` or a ``moe`` group), the final norm and the head."""
    dt = DTYPES[conf["dtype"]]
    d, v, n = conf["d_model"], conf["vocab_size"], conf["n_layers"]
    qd, kvd = conf["n_heads"] * conf["head_dim"], conf["n_kv_heads"] * conf["head_dim"]
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=device)
    layers = {
        "norm1": {"scale": ones(n, d)},
        "norm2": {"scale": ones(n, d)},
        "attn": {"wq": _dense(gen, (n, d, qd), d, dt), "wk": _dense(gen, (n, d, kvd), d, dt),
                 "wv": _dense(gen, (n, d, kvd), d, dt), "wo": _dense(gen, (n, qd, d), qd, dt)},
    }
    moe = conf.get("moe")
    if moe:
        e, f = moe["n_experts"], moe["d_ff_expert"]
        layers["moe"] = {"router": _dense(gen, (n, d, e), d, torch.float32),
                         "up": _dense(gen, (n, e, d, f), d, dt),
                         "down": _dense(gen, (n, e, f, d), f, dt),
                         "gate": _dense(gen, (n, e, d, f), d, dt)}
    else:
        f = conf["d_ff"]
        layers["mlp"] = {"up": _dense(gen, (n, d, f), d, dt),
                         "down": _dense(gen, (n, f, d), f, dt),
                         "gate": _dense(gen, (n, d, f), d, dt)}
    return {"embed": _normal(gen, (v, d), 0.02, dt),
            "final_norm": {"scale": ones(d)},
            "layers": layers,
            "lm_head": _normal(gen, (d, v), 0.02, dt)}


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


def matmul_params(cfg: dict) -> int:
    """Matrix parameters a token passes through: attention, the dense FFN
    or the router and its top-k experts, and the output head (the
    embedding is a lookup)."""
    d = cfg["d_model"]
    qd, kvd = cfg["n_heads"] * cfg["head_dim"], cfg["n_kv_heads"] * cfg["head_dim"]
    per_layer = 2 * d * qd + 2 * d * kvd
    moe = cfg.get("moe")
    if moe:
        per_layer += d * moe["n_experts"] + moe["top_k"] * 3 * d * moe["d_ff_expert"]
    else:
        per_layer += 3 * d * cfg["d_ff"]
    return cfg["n_layers"] * per_layer + d * cfg["vocab_size"]


def attention_flops(cfg: dict, seq: int) -> float:
    """Forward causal attention products of one sequence over all layers:
    2 x S(S+1) x Dh x heads a layer (q.k and p.v)."""
    return 2.0 * seq * (seq + 1) * cfg["head_dim"] * cfg["n_heads"] * cfg["n_layers"]


def smoke(conf: dict, dtype: str) -> dict:
    """Every width cut to the CPU tests' size; GQA stays GQA."""
    conf = dict(conf, d_model=32, n_heads=4, head_dim=8, d_ff=64, vocab_size=128,
                dtype=dtype, n_kv_heads=2 if conf["n_kv_heads"] < conf["n_heads"] else 4)
    if "moe" in conf:
        conf["moe"] = dict(conf["moe"], n_experts=8, top_k=2, d_ff_expert=64)
    return conf
