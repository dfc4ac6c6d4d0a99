"""Sharding layout for every architecture on the production mesh.

Two layers of policy, as in the reference:

1. **Logical activation rules** (consumed by ``repro_torch.models.sharding.shard``):
   per-(config, mesh, mode) mapping of logical axis names to mesh axes, gated
   by divisibility (e.g. ``heads -> "model"`` only when n_heads % model == 0 —
   minitron's 24 and hymba's 25 q-heads stay unsharded while their *weights*
   still split over the model axis).

2. **Parameter specs** (Megatron-style): column-parallel in-proj,
   row-parallel out-proj, expert-parallel MoE banks, vocab-parallel embedding
   (when divisible), with an optional FSDP ("zero-3") axis over ``data`` for
   training mode.

Specs are :class:`PartitionSpec` tuples with the reference's entries, one
per tensor dimension (``None``, an axis name, or a tuple of names), so they
compare one to one with the reference's ``PartitionSpec``.  They depend on
the mesh only through :func:`~repro_torch.launch.mesh.mesh_axis_sizes`;
:func:`named` turns them into DTensor placements on a DeviceMesh, and
:func:`distribute_params` places a tree of tensors (or shape stand-ins on the
``meta`` device) as DTensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.fl._tree import tree_leaves_with_path, tree_map_with_path
from repro_torch.launch.mesh import mesh_axis_sizes
from repro_torch.models.sharding import spec_placements

Params = Any


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry per tensor dimension,
    normalized as JAX does (a one-name tuple is the name, an empty one
    ``None``, a list a tuple)."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                return None if not e else e[0] if len(e) == 1 else tuple(e)
            return e

        return super().__new__(cls, tuple(norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# Logical activation rules
# ---------------------------------------------------------------------------


def build_rules(cfg: ModelConfig, mesh, shape: ShapeConfig,
                *, seq_shard: bool = False) -> Dict[str, Any]:
    ax = mesh_axis_sizes(mesh)
    model = ax.get("model", 1)
    data = ax.get("data", 1)
    pod = ax.get("pod", 1)
    mode = shape.mode

    batch_axes: Tuple[str, ...] = ()
    b = shape.global_batch
    if pod > 1 and b % (pod * data) == 0:
        batch_axes = ("pod", "data")
    elif b % data == 0 and b >= data:
        batch_axes = ("data",)

    rules: Dict[str, Any] = {
        "batch": batch_axes if batch_axes else None,
        "seq": None,
        # Megatron-style activation sequence sharding of the residual stream
        # (remat-stack memory / model): opt-in via seq_shard
        "act_seq": ("model" if seq_shard and shape.mode == "train"
                    and shape.seq_len % model == 0 else None),
        "embed": None,
        # MoE: the ff axis lives inside expert-parallel tensors — expert dim
        # takes the model axis, so per-expert ff stays unsharded
        "ff": ("model" if cfg.d_ff % model == 0 and cfg.moe is None else None),
        "heads": "model" if cfg.n_heads and cfg.n_heads % model == 0 else None,
        "kv_heads": "model" if cfg.n_kv_heads and cfg.n_kv_heads % model == 0 else None,
        "vocab": "model" if cfg.vocab_size % model == 0 else None,
        "expert": "model" if (cfg.moe and cfg.moe.n_experts % model == 0) else None,
        # decode: KV cache length sharded over the model axis (sequence-
        # sharded cache) — batch is already on data
        "cache": "model" if (mode == "decode" and shape.seq_len % model == 0) else None,
    }
    if rules["cache"] == "model":
        # the cache-length axis takes the model mesh axis; kv-head sharding
        # would double-map it (the cache is the dominant decode tensor)
        rules["kv_heads"] = None
    return rules


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------


def _ok(dim: int, axis_size: int) -> bool:
    return axis_size > 1 and dim % axis_size == 0


def param_specs(cfg: ModelConfig, params: Params, mesh, mode: str,
                *, fsdp_on_output: bool = False) -> Params:
    """PartitionSpec tree mirroring ``params``.

    mode "train": 2D FSDPxTP sharding (optimizer state inherits it).
    mode "decode"/"prefill": TP only (weights stationary, replicated on data).

    ``fsdp_on_output``: place the FSDP ("data") shard on the weight's OUTPUT
    dim (stacked with the model axis) instead of the contracting dim: the
    partitioner then gathers the weight shard (~weight bytes) where the
    contracting-dim shard sums partial activations (~activation bytes).
    """
    ax = mesh_axis_sizes(mesh)
    model = ax.get("model", 1)
    data = ax.get("data", 1)
    use_fsdp = mode == "train"

    def fsdp(dim: int) -> Optional[str]:
        return "data" if use_fsdp and _ok(dim, data) else None

    def tp(dim: int) -> Optional[str]:
        return "model" if _ok(dim, model) else None

    def col(shape) -> P:      # (in, out) column-parallel: out over model
        if fsdp_on_output and use_fsdp and _ok(shape[1], data * model):
            return P(None, ("data", "model"))
        return P(fsdp(shape[0]), tp(shape[1]))

    def row(shape) -> P:      # (in, out) row-parallel: in over model
        return P(tp(shape[0]), fsdp(shape[1]))

    def spec_for(keys, leaf) -> P:
        in_layers = "layers" in keys
        shape = tuple(leaf.shape[1:] if in_layers else leaf.shape)  # strip stacked L
        lead = (None,) if in_layers else ()

        name = keys[-1]
        parent = keys[-2] if len(keys) >= 2 else ""

        if name == "embed":
            return P(tp(shape[0]), None)                     # vocab-parallel
        if name == "lm_head":
            return P(None, tp(shape[1]))
        if name == "frontend_proj":
            return P(None, tp(shape[1]))
        if len(shape) <= 1:                                   # norms, biases, u, w0
            return P(*(lead + (None,) * len(shape)))
        if parent in ("attn", "cross_attn"):
            if name == "wo":
                return P(*(lead + tuple(row(shape))))
            return P(*(lead + tuple(col(shape))))
        if parent == "mlp":
            if name == "down":
                return P(*(lead + tuple(row(shape))))
            return P(*(lead + tuple(col(shape))))
        if parent == "moe":
            if name == "router":
                return P(*(lead + (None, None)))
            ep = "model" if _ok(shape[0], model) else None
            if name == "down":   # (E, f, d)
                return P(*(lead + (ep, None, fsdp(shape[2]))))
            return P(*(lead + (ep, fsdp(shape[1]), None)))   # up/gate (E, d, f)
        if parent == "time_mix":
            if name == "wo":
                return P(*(lead + tuple(row(shape))))
            if name in ("wr", "wk", "wv", "wg"):
                return P(*(lead + tuple(col(shape))))
            if name == "w_lora_a":
                return P(*(lead + (fsdp(shape[0]), None)))
            return P(*(lead + (None,) * len(shape)))         # mu, w_lora_b
        if parent == "channel_mix":
            if name == "wv":
                return P(*(lead + tuple(row(shape))))
            if name in ("wk", "wr"):
                return P(*(lead + tuple(col(shape))))
            return P(*(lead + (None,) * len(shape)))
        if parent == "mamba":
            if name in ("in_x", "in_z"):
                return P(*(lead + tuple(col(shape))))
            if name == "conv":
                return P(*(lead + (None, tp(shape[1]))))
            if name == "x_proj":
                return P(*(lead + (tp(shape[0]), None)))
            if name == "dt_proj":
                return P(*(lead + (None, tp(shape[1]))))
            if name == "log_a":
                return P(*(lead + (tp(shape[0]), None)))
            if name == "out":
                return P(*(lead + tuple(row(shape))))
            return P(*(lead + (None,) * len(shape)))
        # fallback: replicate
        return P(*(lead + (None,) * len(shape)))

    return tree_map_with_path(spec_for, params)


# ---------------------------------------------------------------------------
# Decode-state and batch specs
# ---------------------------------------------------------------------------


def decode_state_specs(cfg: ModelConfig, state, mesh, shape: ShapeConfig) -> Any:
    """Specs for the stacked DecodeState: KV cache sequence-sharded over
    ``model``, batch over ``data`` when divisible; SSM states head/channel
    sharded where divisible."""
    rules = build_rules(cfg, mesh, shape)
    ax = mesh_axis_sizes(mesh)
    model = ax.get("model", 1)
    batch_rule = rules["batch"]

    def spec_for(keys, leaf):
        nd = leaf.ndim
        name_path = "/".join(keys)
        if nd == 0:
            return P()
        if "kv" in keys and keys[-1] in ("k", "v") or (
                "cross_kv" in name_path and nd == 5):
            # (L, B, C, KV, Dh)
            cache = rules["cache"] if leaf.shape[2] % model == 0 else None
            if "cross_kv" in name_path:
                cache = "model" if leaf.shape[2] % model == 0 else None
            return P(None, batch_rule, cache, None, None)
        if keys[-1] == "wkv":        # (L, B, H, n, n)
            h = leaf.shape[2]
            return P(None, batch_rule, "model" if h % model == 0 else None,
                     None, None)
        if keys[-1] in ("shift_tm", "shift_cm"):   # (L, B, d)
            return P(None, batch_rule, "model" if leaf.shape[2] % model == 0 else None)
        if keys[-1] == "h":          # mamba (L, B, inner, state)
            return P(None, batch_rule,
                     "model" if leaf.shape[2] % model == 0 else None, None)
        if keys[-1] == "conv":       # (L, B, cw-1, inner)
            return P(None, batch_rule, None,
                     "model" if leaf.shape[3] % model == 0 else None)
        if keys[-1] == "length":
            return P()
        # fallback: batch on dim 1 if it matches
        spec = [None] * nd
        if nd >= 2:
            spec[1] = batch_rule
        return P(*spec)

    return tree_map_with_path(spec_for, state)


def _is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


def named(mesh, spec_tree):
    """Spec tree -> the same tree of DTensor placement lists on ``mesh``."""
    return tree_map_with_path(lambda _, s: spec_placements(mesh, s), spec_tree,
                              is_leaf=_is_spec)


def distribute_params(params: Params, mesh, specs: Params, *,
                      local_device: Optional[str] = None) -> Params:
    """A tree of DTensors, each leaf placed by its spec (any tree: params,
    optimizer state, a batch, a decode state).  A DTensor leaf is
    redistributed.  A ``meta`` leaf (a shape stand-in of
    :mod:`repro_torch.launch.steps`) becomes a DTensor over an empty local
    shard of this rank's shape on ``local_device`` (default: the mesh's
    device type; ``"meta"`` allocates nothing)."""
    flat_specs = {path: s for path, s in tree_leaves_with_path(specs, _is_spec)}

    def place(path, leaf):
        placements = spec_placements(mesh, flat_specs[path])
        if isinstance(leaf, DTensor):
            return leaf.redistribute(mesh, placements)
        if leaf.is_meta:
            return _empty_dtensor(leaf.shape, leaf.dtype, mesh, placements,
                                  local_device or mesh.device_type)
        return distribute_tensor(leaf, mesh, placements)

    return tree_map_with_path(place, params)


def local_shape(shape, mesh, placements) -> Tuple[int, ...]:
    """This rank's shard shape of a ``shape`` tensor placed by ``placements``
    (``torch.chunk``'s split, mesh dimensions in order)."""
    out = list(shape)
    coord = mesh.get_coordinate()
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            n, k = out[p.dim], mesh.size(m)
            chunk = -(-n // k)
            out[p.dim] = max(0, min(n - coord[m] * chunk, chunk))
    return tuple(out)


def _empty_dtensor(shape, dtype, mesh, placements, device) -> DTensor:
    local = torch.empty(local_shape(shape, mesh, placements), dtype=dtype, device=device)
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))
