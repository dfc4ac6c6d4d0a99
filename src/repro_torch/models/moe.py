"""Mixture-of-experts FFN with top-k routing.

Two dispatch implementations, as in the reference:

* ``dispatch="sort"`` (default, deployable) — grouped sort-based dispatch:
  tokens are split into G groups, each group sorts its token->expert
  assignments (a stable sort) and gathers at most ``capacity`` tokens per
  expert into a (G, E, C, d) buffer; the expert FFNs are batched products
  over that buffer.
* ``dispatch="dense"`` — the GShard/Switch one-hot-einsum formulation, the
  reference's baseline: its (T, E, C) dispatch tensors grow as T^2 k / E.

Aux losses: Switch load-balance loss + router z-loss.

Departures from the reference, none of which changes a result beyond fp32
summation order:

* The groups run as one batched computation over a leading G axis, in
  place of ``jax.vmap`` over a per-group function.
* Routing takes the top k by a stable descending sort, so a tie goes to
  the lowest expert index as in ``jax.lax.top_k`` (``torch.topk`` promises
  no tie order on CUDA).  Per-expert counts come from a one-hot sum, not
  ``bincount``: no data-dependent shape, so ``torch.func.vmap`` batches the
  whole layer (``bincount`` has no batching rule).
* The combine gathers each token's k expert outputs and sums them in a
  fixed order (fp32), where the reference scatter-adds the slots into their
  tokens: the same terms, and deterministic on the card, where a float
  scatter-add runs on atomics.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation_fn, dense_init_on, is_gated
from repro_torch.models.sharding import local_map_channels, reshape, shard

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: Tuple[int, ...] = ()) -> Params:
    """``router`` (d, E) in fp32, ``up``/``gate`` (E, d, f) and ``down``
    (E, f, d) in ``dtype``; every leaf with ``lead`` stacked axes first."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.n_experts
    p = {
        "router": dense_init_on(gen, d, e, torch.float32, lead),   # router kept fp32
        "up": dense_init_on(gen, d, f, dtype, lead + (e,)),
        "down": dense_init_on(gen, f, d, dtype, lead + (e,)),
    }
    if is_gated(cfg.activation):
        p["gate"] = dense_init_on(gen, d, f, dtype, lead + (e,))
    return p


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    cap = int(n_tokens * top_k / n_experts * factor)
    return max(8, ((cap + 7) // 8) * 8)  # the reference's padding to 8


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes (all zeros out of range)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(p: Params, xt: torch.Tensor, moe) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """xt: (T, d) -> (gate_vals (T,k), idx (T,k), aux)."""
    t = xt.shape[0]
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    # top k, ties to the lowest index (jax.lax.top_k's order)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = srt[:, :moe.top_k], order[:, :moe.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=0)
    ce = _one_hot(idx, moe.n_experts).sum(dim=(0, 1)) / (t * moe.top_k)
    aux = {
        "load_balance_loss": moe.n_experts * torch.sum(me * ce),
        "router_z_loss": torch.mean(torch.square(torch.logsumexp(logits, dim=-1))),
        "expert_fraction": ce,
    }
    return gate_vals, idx, aux


# ---------------------------------------------------------------------------
# Sort-based dispatch (deployable default)
# ---------------------------------------------------------------------------


def _sort_dispatch_group(xg: torch.Tensor, gate: torch.Tensor, idx: torch.Tensor,
                         e: int, cap: int, k: int):
    """Every group's dispatch at once. xg: (G, Tg, d); gate/idx: (G, Tg, k).

    Returns (xin (G, E*C, d), slot_token (G, E*C), slot_gate (G, E*C),
    dropped (G,), token_slot (G, Tg*k)): the reference's four per group,
    and the slot of each (token, choice) in flat order (``E*C`` where it
    was dropped) for the combine."""
    g, tg = xg.shape[:2]
    dev = xg.device
    flat_e = idx.reshape(g, tg * k)                            # (G, Tg*k)
    flat_gate = gate.reshape(g, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    counts = _one_hot(flat_e, e).sum(dim=1).long()             # (G, E)
    starts = torch.cumsum(counts, dim=1) - counts
    pos = torch.arange(tg * k, device=dev) - torch.gather(starts, 1, sorted_e)
    valid = pos < cap
    slot = torch.where(valid, sorted_e * cap + pos, torch.full_like(pos, e * cap))
    token_sorted = order // k
    # slot -> token map (dummy row E*C at the end, dropped after the scatter)
    slot_token = torch.full((g, e * cap + 1), tg, dtype=torch.long, device=dev).scatter(
        1, slot, token_sorted)[:, :e * cap]
    gate_sorted = torch.gather(flat_gate, 1, order)
    slot_gate = torch.zeros((g, e * cap + 1), dtype=torch.float32, device=dev).scatter(
        1, slot, gate_sorted * valid)[:, :e * cap]
    # (token, choice) -> slot: ``order`` is a permutation, so the scatter is 1:1
    token_slot = torch.empty_like(slot).scatter(1, order, slot)
    xg_pad = torch.cat([xg, torch.zeros_like(xg[:, :1])], dim=1)
    xin = torch.gather(xg_pad, 1, slot_token[..., None].expand(-1, -1, xg.shape[-1]))
    dropped = 1.0 - valid.float().mean(dim=1)
    return xin, slot_token, slot_gate, dropped, token_slot


def _expert_ffn(p: Params, xin: torch.Tensor, cfg: ModelConfig, lead: str) -> torch.Tensor:
    """The experts' FFN over ``xin`` (lead..., E, C, d); ``lead`` names the
    leading axes for the einsums ("g" or "").  On a mesh each rank runs its
    own groups through its own experts (the banks' other shards gathered)."""
    act = activation_fn(cfg.activation)
    gated = is_gated(cfg.activation)

    def ffn(xin, w_up, w_down, w_gate):
        up = torch.einsum(f"{lead}ecd,edf->{lead}ecf", xin, w_up)
        if gated:
            up = act(torch.einsum(f"{lead}ecd,edf->{lead}ecf", xin, w_gate)) * up
        else:
            up = act(up)
        return (torch.einsum(f"{lead}ecf,efd->{lead}ecd", up, w_down),)

    e_dim = len(lead)
    lead_dims = (0 if lead else None, e_dim)
    out, = local_map_channels(ffn, (xin, p["up"], p["down"], p.get("gate")),
                              [lead_dims] + [(None, 0)] * 3, [lead_dims])
    return out


def _apply_moe_sort(p: Params, x: torch.Tensor, cfg: ModelConfig, n_groups: int
                    ) -> Tuple[torch.Tensor, Dict]:
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    g = max(1, n_groups)
    while t % g:
        g //= 2
    tg = t // g
    e, k = moe.n_experts, moe.top_k
    cap = _capacity(tg, e, k, moe.capacity_factor)

    xt = reshape(x, t, d)
    gate_vals, idx, aux = _route(p, xt, moe)
    # on a mesh each rank dispatches and combines its own groups
    xin, _, slot_gate, dropped, token_slot = local_map_channels(
        lambda xg, gg, ig: _sort_dispatch_group(xg, gg, ig, e, cap, k),
        (reshape(xt, g, tg, d), reshape(gate_vals, g, tg, k), reshape(idx, g, tg, k)),
        [(0, None)] * 3, [(0, None)] * 5)
    aux["dropped_fraction"] = dropped.mean()

    # (G, E, C, d): groups on data, experts on model -> the EP all-to-all edge
    xin = shard(reshape(xin, g, e, cap, d), "batch", "expert", None, "embed")
    out = _expert_ffn(p, xin, cfg, "g")                                 # (G, E, C, d)
    out = shard(out, "batch", "expert", None, "embed")

    # the combine's rows come back as (B, S, d) from each rank's groups (its
    # batch rows: groups are contiguous runs of tokens), so no DTensor view
    # reshapes them
    y, = local_map_channels(lambda o, sg, ts: (_combine(o, sg, ts, k).reshape(-1, s, d),),
                            (out, slot_gate, token_slot), [(0, None)] * 3, [(0, None)])
    return y.to(x.dtype), aux


def _combine(out: torch.Tensor, slot_gate: torch.Tensor, token_slot: torch.Tensor,
             k: int) -> torch.Tensor:
    """Each token's k slots of ``out`` (G, E, C, d) gathered (the dummy slot
    E*C reads a zero row) and weighted by their gates, summed over the k
    choices in fp32: (G, Tg, d)."""
    g, e, cap, d = out.shape
    flat = torch.cat([out.reshape(g, e * cap, d).float(),
                      torch.zeros((g, 1, d), dtype=torch.float32, device=out.device)], dim=1)
    picked = torch.gather(flat, 1, token_slot[..., None].expand(-1, -1, d))  # (G, Tg*k, d)
    w = torch.cat([slot_gate, torch.zeros_like(slot_gate[:, :1])], dim=1)
    w = torch.gather(w, 1, token_slot)                                 # gate * valid
    return (picked * w[..., None]).reshape(g, -1, k, d).sum(dim=2)


# ---------------------------------------------------------------------------
# Dense (GShard) dispatch — the reference's baseline
# ---------------------------------------------------------------------------


def _apply_moe_dense(p: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, Dict]:
    moe = cfg.moe
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    e, k = moe.n_experts, moe.top_k
    gate_vals, idx, aux = _route(p, xt, moe)
    cap = _capacity(t, e, k, moe.capacity_factor)

    onehot = _one_hot(idx, e)                                          # (T, k, E)
    flat_onehot = onehot.reshape(t * k, e)
    pos_in_expert = (torch.cumsum(flat_onehot, dim=0) - flat_onehot).reshape(t, k, e)
    pos = torch.sum(pos_in_expert * onehot, dim=-1).long()
    keep = pos < cap
    gate_kept = gate_vals * keep
    pos_oh = _one_hot(pos, cap)
    dispatch = torch.einsum("tke,tkc->tec", onehot * keep[..., None], pos_oh)
    combine = torch.einsum("tke,tkc->tec", gate_kept[..., None] * onehot, pos_oh)
    aux["dropped_fraction"] = 1.0 - torch.sum(keep) / (t * k)

    xin = torch.einsum("tec,td->ecd", dispatch, xt.float()).to(x.dtype)
    xin = shard(xin, "expert", None, "embed")
    out = shard(_expert_ffn(p, xin, cfg, ""), "expert", None, "embed")
    y = torch.einsum("tec,ecd->td", combine, out.float()).to(x.dtype)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (y, aux)."""
    moe = cfg.moe
    if moe.dispatch == "dense":
        return _apply_moe_dense(p, x, cfg)
    return _apply_moe_sort(p, x, cfg, moe.n_groups or 1)


def moe_aux_loss(aux: Dict, cfg: ModelConfig) -> torch.Tensor:
    moe = cfg.moe
    return (moe.load_balance_coef * aux["load_balance_loss"]
            + moe.router_z_coef * aux["router_z_loss"])
