"""Logical-axis sharding annotations for model code.

Model code annotates activations with *logical* axis names
(``shard(x, "batch", "seq", "heads", None)``).  The launch layer installs a
mapping from logical names to mesh axes via :func:`use_logical_rules`; outside
any mapping, or on a plain tensor, the annotation returns its input, so the
model code runs unchanged on one device.

On a DTensor, :func:`shard` is the counterpart of the reference's
``with_sharding_constraint``: it redistributes ``x`` to the placements of its
logical spec.  A spec is the reference's ``PartitionSpec`` as a tuple with
one entry per tensor dimension: ``None``, a mesh axis name, or a tuple of
names (in mesh order) that shard that dimension together.  While rules are
installed, plain tensors that meet DTensors count as replicated
(``implicit_replication``), as XLA treats a constant.

Where DTensor cannot follow GSPMD, the model code calls the helpers below,
each the plain code on plain tensors: :func:`local_map_heads` (an attention
core) and :func:`local_map_channels` (a scan, a WKV core, an MoE group's
work) run on each rank's local shards; :func:`embed_lookup` is the
vocabulary-parallel lookup; :func:`whole_heads`, :func:`replicate` and
:func:`gather_fsdp` gather what a split or a product must see whole;
:func:`reshape` keeps a reshape's gradient in a layout its backward can
take.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication, local_map

_state = threading.local()

AxisName = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisName, ...]


def _rules() -> Optional[Dict[str, AxisName]]:
    return getattr(_state, "rules", None)


def _mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_logical_rules(mesh, rules: Dict[str, AxisName]):
    """Install logical->mesh axis rules (and implicit replication of plain
    tensors) for the duration of a step."""
    prev = (_rules(), _mesh())
    _state.rules, _state.mesh = dict(rules), mesh
    try:
        with implicit_replication():
            yield
    finally:
        _state.rules, _state.mesh = prev


def logical_to_spec(*axes: Optional[str]) -> Spec:
    rules = _rules() or {}
    return tuple(rules.get(a) if a is not None else None for a in axes)


def _entry_axes(entry: AxisName) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(mesh, spec: Sequence[AxisName]) -> List[Any]:
    """A per-dimension spec -> one placement per mesh dimension.  An entry
    of several axes shards its dimension over each of them; DTensor splits
    in mesh-dimension order, JAX major to minor, so the axes must be listed
    in mesh order.  An axis of size 1 splits nothing and stays
    ``Replicate`` (DTensor cannot reshape a dimension "sharded" over one
    rank)."""
    names = list(mesh.mesh_dim_names)
    placements: List[Any] = [Replicate()] * len(names)
    seen = set()
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists mesh axes out of mesh "
                             f"order {tuple(names)}")
        for i in idx:
            if i in seen:
                raise ValueError(f"mesh axis {names[i]!r} appears twice in {tuple(spec)}")
            seen.add(i)
            if mesh.size(i) > 1:
                placements[i] = Shard(dim)
    return placements


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain ``x`` to its logical axes; a no-op without installed rules
    or on a plain tensor."""
    mesh = _mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = spec_placements(x.device_mesh, logical_to_spec(*axes))
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def replicate(x: torch.Tensor, dims: Sequence[int]) -> torch.Tensor:
    """``x`` with no mesh axis on ``dims`` and no pending sum; other
    dimensions keep their shards.  A no-op on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    nd = x.ndim
    want = []
    for p in x.placements:
        if isinstance(p, Partial) or (isinstance(p, Shard) and
                                      p.dim % nd in {d % nd for d in dims}):
            want.append(Replicate())
        else:
            want.append(_norm(p, nd))
    if want == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight with its FSDP shards (the ``data`` axis of
    ``launch.sharding.param_specs``' train mode) gathered, its
    tensor-parallel shards kept: ZeRO-3's gather before use, so a product
    never sums its contracting dimension across ranks.  A no-op on a plain
    tensor."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    want = [Replicate() if names[m] == "data" and isinstance(p, Shard) else _norm(p, w.ndim)
            for m, p in enumerate(w.placements)]
    if want == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def as_dtensor(x: torch.Tensor, mesh) -> DTensor:
    """``x`` as a DTensor on ``mesh``: a plain tensor counts as replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def distribute_like(x: torch.Tensor, like: DTensor) -> DTensor:
    """``x`` (a DTensor or a plain, replicated tensor) laid out as ``like``."""
    x = as_dtensor(x, like.device_mesh)
    if x.placements == like.placements:
        return x
    return x.redistribute(like.device_mesh, like.placements)


class _PinGrad(torch.autograd.Function):
    """Identity whose gradient takes the forward value's layout."""

    @staticmethod
    def forward(ctx, x):
        # a pending sum's gradient is whole on every rank
        ctx.layout = (x.device_mesh, tuple(Replicate() if isinstance(p, Partial)
                                           else _norm(p, x.ndim) for p in x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, placements = ctx.layout
        if isinstance(g, DTensor) and tuple(g.placements) != placements:
            norm = [_norm(p, g.ndim) for p in g.placements]
            if norm != list(g.placements):     # the same layout, its dims written >= 0
                g = DTensor.from_local(g.to_local(), mesh, norm, run_check=False,
                                       shape=g.shape, stride=g.stride())
            g = g.redistribute(mesh, placements)
        return g


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient comes back laid out as ``x`` is (an identity
    on a plain tensor)."""
    return _PinGrad.apply(x) if isinstance(x, DTensor) else x


def reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(shape)``; on a DTensor the gradient coming back is laid
    out as the forward result was, so the backward's reverse reshape never
    meets shards it cannot split (the layout DTensor's backward picks for a
    product's gradient may cut a head in two)."""
    return pin_grad(x.reshape(*shape))


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x`` (..., k) and a 2-D ``w``.  On a DTensor the
    leading dimensions are folded into one by :func:`reshape` before the
    product and unfolded after it, so the folded gradient comes back in the
    forward layout: DTensor's backward of a product may shard the folded
    token dimension over an axis that the batch is too short for, and
    could not unfold it (RWKV6 with a batch smaller than ``data``)."""
    if not isinstance(x, DTensor) or x.ndim <= 2:
        return x @ w
    lead = x.shape[:-1]
    return reshape(reshape(x, math.prod(lead), x.shape[-1]) @ w, *lead, w.shape[-1])


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on DTensors the vocabulary-parallel lookup (the
    ``local_map`` pattern): each rank looks up, in its rows of the table,
    the tokens of its batch rows that fall there, zero elsewhere, and the
    rows of the ranks that split the vocabulary make a pending sum.  The
    table's gradient is then a local ``index_put`` on each rank (DTensor's
    own strategy for it fails on some releases)."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    vocab = [m for m, p in enumerate(table.placements) if _is_shard(p, 0, 2)]
    rows = [m for m, p in enumerate(tokens.placements)
            if _is_shard(p, 0, tokens.ndim) and m not in vocab]
    t_pl = tuple(Shard(0) if m in rows else Replicate() for m in range(mesh.ndim))
    w_pl = tuple(Shard(0) if m in vocab else Replicate() for m in range(mesh.ndim))
    o_pl = tuple(Partial() if m in vocab else Shard(0) if m in rows else Replicate()
                 for m in range(mesh.ndim))
    v0 = local_offset(table, 0)

    def lookup(w, t):
        if not vocab:
            return w[t]
        ids = t - v0
        hit = (ids >= 0) & (ids < w.shape[0])
        return w[ids.clamp(0, w.shape[0] - 1)] * hit[..., None].to(w.dtype)

    return local_map(lookup, out_placements=(o_pl,), in_placements=(w_pl, t_pl),
                     in_grad_placements=(tuple(Partial() if m in rows else p
                                               for m, p in enumerate(w_pl)), t_pl),
                     device_mesh=mesh, redistribute_inputs=True)(table, tokens)


def whole_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` (..., n * dh) ready to split its last dimension into ``n``
    heads: gathered where its shards would cut through a head.  A no-op on a
    plain tensor."""
    if not isinstance(x, DTensor):
        return x
    split = math.prod(x.device_mesh.size(m) for m, p in enumerate(x.placements)
                      if _is_shard(p, x.ndim - 1, x.ndim))
    return x if n % split == 0 else replicate(x, dims=(x.ndim - 1,))


def local_offset(x: DTensor, dim: int) -> int:
    """The global index of this rank's first element of ``x`` along ``dim``
    (even shards, mesh-dimension order)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    start, size = 0, x.shape[dim]
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == dim:
            size //= mesh.size(m)
            start += coord[m] * size
    return start


def _is_shard(p, dim: int, ndim: int) -> bool:
    return isinstance(p, Shard) and p.dim % ndim == dim % ndim


def _norm(p, ndim: int):
    """``Shard(-1)`` as ``Shard(ndim - 1)``: some DTensor releases reject a
    negative shard dimension in their strategies."""
    return Shard(p.dim % ndim) if isinstance(p, Shard) and p.dim < 0 else p


def local_map_heads(fn: Callable[..., torch.Tensor], q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` over heads, on each rank's local shards
    (``torch.distributed.tensor.experimental.local_map``).

    ``q`` is (B, S, H, Dh) and ``k``/``v`` (B, Sk, KV, Dh) with H a multiple
    of KV; ``fn`` returns a tensor shaped like ``q``.  Attention is
    independent per batch row and per head, so each rank runs ``fn`` on its
    own rows and q heads: ``q`` keeps its batch and head shards (others are
    gathered), ``k``/``v`` take ``q``'s batch shards and its head shards where
    the KV heads split alike.  Where they do not (KV heads too few for the
    axis), K/V are gathered over that axis and each rank takes the KV head of
    each of its q heads, so ``fn`` sees one KV head per q head.  On plain
    tensors this is ``fn(q, k, v)``.
    """
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh = q.device_mesh
    hq, hk = q.shape[2], k.shape[2]
    qp = [_norm(p, 4) if (_is_shard(p, 0, 4) or _is_shard(p, 2, 4)) and mesh.size(m) > 1
          else Replicate() for m, p in enumerate(q.placements)]
    aligned = all(not _is_shard(p, 2, 4) or hk % mesh.size(m) == 0
                  for m, p in enumerate(qp))
    kp = [p if _is_shard(p, 0, 4) or aligned else Replicate() for p in qp]
    core = fn
    if not aligned:
        q = q.redistribute(mesh, qp)
        h0 = local_offset(q, 2)
        nl = hq // math.prod(mesh.size(m) for m, p in enumerate(qp) if _is_shard(p, 2, 4))
        idx = (torch.arange(h0, h0 + nl, device=q.to_local().device) // (hq // hk))

        def core(ql, kl, vl):
            return fn(ql, kl.index_select(2, idx), vl.index_select(2, idx))

    qp, kp = tuple(qp), tuple(kp)
    # K/V gathered over an axis that splits the work: each rank's gradient
    # is its heads' share, a pending sum
    kg = tuple(Partial() if k_ == Replicate() and q_ != Replicate() else k_
               for q_, k_ in zip(qp, kp))
    return local_map(core, out_placements=(qp,), in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kg, kg), device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


def local_map_channels(fn: Callable[..., Tuple[torch.Tensor, ...]],
                       args: Sequence[Optional[torch.Tensor]],
                       arg_dims: Sequence[Tuple[Optional[int], Optional[int]]],
                       out_dims: Sequence[Tuple[Optional[int], Optional[int]]]
                       ) -> Tuple[torch.Tensor, ...]:
    """``fn(*args)`` on each rank's local shards
    (``torch.distributed.tensor.experimental.local_map``), for a function
    independent per batch row and per channel (a selective scan, a WKV core,
    an MoE group's dispatch).

    ``arg_dims`` names each argument's (batch, channel) dimensions, None
    where it has none; ``out_dims`` the same for each of ``fn``'s outputs
    (non-negative).  Every mesh axis that shards the first argument's batch
    dimension shards each batch dimension alike, and likewise for the
    channel dimension; all other shards and pending sums are resolved first,
    and a plain tensor counts as replicated.  On plain tensors this is
    ``fn(*args)``.
    """
    lead = args[0]
    if not isinstance(lead, DTensor):
        return fn(*args)
    mesh = lead.device_mesh
    b0, c0 = arg_dims[0]
    role, split = [], {"b": 1, "c": 1}
    for m, p in enumerate(lead.placements):
        r = ("b" if b0 is not None and _is_shard(p, b0, lead.ndim)
             else "c" if c0 is not None and _is_shard(p, c0, lead.ndim) else None)
        # only even shards stay (a dimension too short for its axes is gathered)
        if r is not None and (mesh.size(m) == 1 or
                              lead.shape[b0 if r == "b" else c0] % (split[r] * mesh.size(m))):
            r = None
        if r is not None:
            split[r] *= mesh.size(m)
        role.append(r)

    def placements(dims, ndim):
        b, c = dims
        return tuple(Shard(b % ndim) if r == "b" and b is not None
                     else Shard(c % ndim) if r == "c" and c is not None else Replicate()
                     for r in role)

    dargs, in_pl = [], []
    for a, dims in zip(args, arg_dims):
        if a is None:
            dargs.append(None)
            in_pl.append(None)
            continue
        a = as_dtensor(a, mesh)
        dargs.append(a)
        in_pl.append(placements(dims, a.ndim))
    # an input whole on an axis that splits the work: each rank's gradient
    # is its share, a pending sum
    grad_pl = tuple(None if pl is None else tuple(
        Partial() if p == Replicate() and r is not None else p for p, r in zip(pl, role))
        for pl in in_pl)
    out_pl = tuple(placements(d, 1 + max(x for x in d if x is not None)) for d in out_dims)
    return local_map(fn, out_placements=out_pl, in_placements=tuple(in_pl),
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*dargs)
