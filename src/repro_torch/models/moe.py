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

What the reference's layer lacks, for the port-only DeepSeek-V2-Lite
(:class:`repro_torch.configs.deepseek_v2_lite.SharedMoEConfig`; its
defaults, which the base :class:`~repro_torch.configs.base.MoEConfig` keeps
as class attributes, leave OLMoE and phi3.5-moe as they were):

* gates that stay unrenormalised (``norm_topk_prob`` False: the top-k
  softmax probabilities as they are; the published
  ``routed_scaling_factor`` is 1);
* ``n_shared_experts`` shared experts: one SwiGLU of their summed width
  (``p["shared"]``) over every token, added to the routed output;
* the sequence-level balance loss (``seq_aux``): ``mean over sequences of
  sum_e f_e P_e`` with ``f_e = E / (k S) x`` the sequence's choices of e and
  ``P_e`` its mean probability of e, weighted by ``load_balance_coef``;
  no router z-loss where ``router_z_coef`` is 0;
* an expert layer told which routed experts it holds (``experts_held``
  from ``expert_offset``), as one share of expert parallelism: it routes
  over all ``n_experts``, keeps the capacity per expert of the full layer,
  and computes only its own experts' part of the result; the pairs routed
  elsewhere take no slot.  The parts of all shares, with the shared experts
  counted once, add up to the whole layer.

Every expert layer opens the span ``moe``.  Outside any ``torch.func``
transform and under an active recorder it also counts, as device tensors
the recorder resolves at its flush: ``moe.slots`` (held experts x capacity
rows computed), ``moe.pairs_held`` and ``moe.pairs_kept`` (the (token,
choice) pairs routed to the held experts, before and after the capacity).

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

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import activation_fn, apply_mlp, dense_init_on, init_mlp, is_gated
from repro_torch.models.sharding import local_map_channels, reshape, shard
from repro_torch.obs.profiling import active_profiler, span

Params = Dict[str, torch.Tensor]


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             lead: Tuple[int, ...] = ()) -> Params:
    """``router`` (d, E) in fp32, ``up``/``gate`` (E_held, d, f) and
    ``down`` (E_held, f, d) in ``dtype``, and the shared experts' ``shared``
    MLP where the layer has them; every leaf with ``lead`` stacked axes
    first."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_ff_expert, moe.n_experts
    p = {
        "router": dense_init_on(gen, d, e, torch.float32, lead),   # router kept fp32
        "up": dense_init_on(gen, d, f, dtype, lead + (moe.held,)),
        "down": dense_init_on(gen, f, d, dtype, lead + (moe.held,)),
    }
    if is_gated(cfg.activation):
        p["gate"] = dense_init_on(gen, d, f, dtype, lead + (moe.held,))
    if moe.n_shared_experts:
        p["shared"] = init_mlp(gen, d, moe.d_ff_shared, cfg.activation, dtype, lead)
    return p


def _capacity(n_tokens: int, n_experts: int, top_k: int, factor: float) -> int:
    cap = int(n_tokens * top_k / n_experts * factor)
    return max(8, ((cap + 7) // 8) * 8)  # the reference's padding to 8


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """fp32 one-hot of ``idx`` over ``n`` classes (all zeros out of range)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _route(p: Params, xt: torch.Tensor, moe, seq_len: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, Dict]:
    """xt: (T, d), T = sequences x ``seq_len`` (None: one sequence) ->
    (gate_vals (T,k), idx (T,k), aux)."""
    t = xt.shape[0]
    e, k = moe.n_experts, moe.top_k
    logits = xt.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    # top k, ties to the lowest index (jax.lax.top_k's order)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = srt[:, :k], order[:, :k]
    if moe.norm_topk_prob:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    chosen = _one_hot(idx, e)                                          # (T, k, E)
    ce = chosen.sum(dim=(0, 1)) / (t * k)
    if moe.seq_aux:
        seq_len = seq_len or t
        f = chosen.reshape(-1, seq_len * k, e).sum(dim=1) * (e / (seq_len * k))
        balance = torch.sum(f * probs.reshape(-1, seq_len, e).mean(dim=1), dim=-1).mean()
    else:
        balance = e * torch.sum(probs.mean(dim=0) * ce)
    aux = {"load_balance_loss": balance, "expert_fraction": ce}
    if moe.router_z_coef:
        aux["router_z_loss"] = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    return gate_vals, idx, aux


def _count(masks, slots: int) -> None:
    """The layer's counters, where an active recorder is there to take them
    and no ``torch.func`` transform is (no number leaves ``vmap(grad)``):
    device tensors, resolved at the recorder's flush.  ``masks()`` gives
    ``(held_pairs, kept)``: a count, or a mask of the pairs routed to the
    held experts, and a mask of those that took a slot; it is called only
    then, so an untraced layer launches nothing for its counters."""
    prof = active_profiler()
    if prof is None or torch._C._functorch.peek_interpreter_stack() is not None:
        return
    held_pairs, kept = masks()
    if isinstance(kept, DTensor):
        return
    prof.metrics.count("moe.slots", slots)
    prof.metrics.count("moe.pairs_held", held_pairs if isinstance(held_pairs, int)
                       else held_pairs.sum())
    prof.metrics.count("moe.pairs_kept", kept.sum())


# ---------------------------------------------------------------------------
# Sort-based dispatch (deployable default)
# ---------------------------------------------------------------------------


def _sort_dispatch_group(xg: torch.Tensor, gate: torch.Tensor, idx: torch.Tensor,
                         e: int, cap: int, k: int, held: Optional[Tuple[int, int]] = None):
    """Every group's dispatch at once. xg: (G, Tg, d); gate/idx: (G, Tg, k).
    ``held``: (first expert, count) of a layer that holds a share of the E
    experts; the other experts' pairs take no slot (a pair's place in its
    expert's queue counts every pair, so the capacity is the full layer's).

    Returns (xin (G, H*C, d), slot_token (G, H*C), slot_gate (G, H*C),
    dropped (G,), token_slot (G, Tg*k)), H the experts held: the
    reference's four per group (``dropped``: the share of the held
    experts' pairs past the capacity), and the slot of each (token, choice)
    in flat order (``H*C`` where it has none) for the combine."""
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
    in_share = None
    if held is not None:
        sorted_e = sorted_e - held[0]
        in_share = (sorted_e >= 0) & (sorted_e < held[1])
        valid = valid & in_share
        e = held[1]
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
    if in_share is None:
        dropped = 1.0 - valid.float().mean(dim=1)
    else:
        dropped = 1.0 - valid.sum(dim=1) / torch.clamp(in_share.sum(dim=1), min=1)
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


def _held(moe) -> Optional[Tuple[int, int]]:
    """``(first, count)`` of a layer holding a share of its experts, else
    None."""
    return (moe.expert_offset, moe.held) if moe.held < moe.n_experts else None


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
    held = _held(moe)

    xt = reshape(x, t, d)
    gate_vals, idx, aux = _route(p, xt, moe, s)
    # on a mesh each rank dispatches and combines its own groups
    xin, _, slot_gate, dropped, token_slot = local_map_channels(
        lambda xg, gg, ig: _sort_dispatch_group(xg, gg, ig, e, cap, k, held),
        (reshape(xt, g, tg, d), reshape(gate_vals, g, tg, k), reshape(idx, g, tg, k)),
        [(0, None)] * 3, [(0, None)] * 5)
    aux["dropped_fraction"] = dropped.mean()
    _count(lambda: (t * k if held is None else (idx >= held[0]) & (idx < held[0] + held[1]),
                    token_slot < moe.held * cap), g * moe.held * cap)

    # (G, E, C, d): groups on data, experts on model -> the EP all-to-all edge
    xin = shard(reshape(xin, g, moe.held, cap, d), "batch", "expert", None, "embed")
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
    gate_vals, idx, aux = _route(p, xt, moe, s)
    cap = _capacity(t, e, k, moe.capacity_factor)

    onehot = _one_hot(idx, e)                                          # (T, k, E)
    flat_onehot = onehot.reshape(t * k, e)
    pos_in_expert = (torch.cumsum(flat_onehot, dim=0) - flat_onehot).reshape(t, k, e)
    pos = torch.sum(pos_in_expert * onehot, dim=-1).long()
    keep = pos < cap
    held = _held(moe)
    if held is not None:                       # a share: its own experts' columns
        onehot = onehot[..., held[0]:held[0] + held[1]]
        held_pairs = onehot.sum(-1) > 0
        keep = keep & held_pairs
    gate_kept = gate_vals * keep
    pos_oh = _one_hot(pos, cap)
    dispatch = torch.einsum("tke,tkc->tec", onehot * keep[..., None], pos_oh)
    combine = torch.einsum("tke,tkc->tec", gate_kept[..., None] * onehot, pos_oh)
    if held is None:
        aux["dropped_fraction"] = 1.0 - torch.sum(keep) / (t * k)
        held_pairs = t * k
    else:
        aux["dropped_fraction"] = 1.0 - torch.sum(keep) / torch.clamp(held_pairs.sum(), min=1)
    _count(lambda: (held_pairs, keep), moe.held * cap)

    xin = torch.einsum("tec,td->ecd", dispatch, xt.float()).to(x.dtype)
    xin = shard(xin, "expert", None, "embed")
    out = shard(_expert_ffn(p, xin, cfg, ""), "expert", None, "embed")
    y = torch.einsum("tec,ecd->td", combine, out.float()).to(x.dtype)
    return y.reshape(b, s, d), aux


# ---------------------------------------------------------------------------


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) -> (y, aux): the routed experts held here, plus the
    shared experts where the layer has them.  Opens the span ``moe``."""
    moe = cfg.moe
    with span("moe"):
        if moe.dispatch == "dense":
            y, aux = _apply_moe_dense(p, x, cfg)
        else:
            y, aux = _apply_moe_sort(p, x, cfg, moe.n_groups or 1)
        if moe.n_shared_experts:
            y = y + apply_mlp(p["shared"], x, cfg.activation)
        return y, aux


def moe_aux_loss(aux: Dict, cfg: ModelConfig) -> torch.Tensor:
    """``load_balance_coef`` x the balance loss, plus ``router_z_coef`` x
    the router z-loss where the layer has one."""
    moe = cfg.moe
    if not moe.router_z_coef:
        return moe.load_balance_coef * aux["load_balance_loss"]
    return (moe.load_balance_coef * aux["load_balance_loss"]
            + moe.router_z_coef * aux["router_z_loss"])
