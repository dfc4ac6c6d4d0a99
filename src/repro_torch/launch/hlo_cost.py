"""Per-device cost of one call of a step, counted op by op.

The reference reads the compiled, SPMD-partitioned HLO text of a jitted
step (its ``parse_hlo``/``analyze``), so every number is per chip.  The port
has no compiled program to read: :func:`analyze_step` runs the step once
(in the dry-run on DTensors over ``meta`` local shards, so nothing is
computed or allocated) under a dispatch mode that sees every op a rank
executes.  On DTensors the mode
steps aside for the DTensor-level op (returning ``NotImplemented``) and
counts the ops DTensor then runs on the local shards, and the collectives
its redistributions issue; the global-shape ops DTensor runs only to infer
output shapes are not counted.  So, per device:

* **flops** — ``2*M*N*K`` for each matrix product, from the local shapes
  (``dot_flops``, through ``torch.utils.flop_counter``'s formulas), plus
  output elements for each pointwise op and input elements for each
  reduction.  The kernel ops (``repro_torch::flash_attention``,
  ``::selective_scan``, ``::wkv6``: the dry-run's ``impl="flash"``) count
  their work by :func:`repro_torch.kernels.work.op_work`, the formulas of
  ``chip_smoke.py``'s bound column: flash attention's two products over the
  unmasked pairs as ``dot_flops``, the scans' operations as ``flops`` only;
* **bytes** — each local op's operand and result bytes.  This is an eager,
  unfused count: every op reads its inputs from and writes its outputs to
  device memory, where a fused program keeps intermediates on chip (for a
  kernel op, which is fused, it is its real traffic).  Views
  and metadata ops cost nothing; ``convert_bytes`` is the part of ``bytes``
  spent in dtype conversions;
* **collective bytes** — per kind (the reference's names), with wire bytes
  under the reference's ring model (:func:`_collective_cost`).

``Cost`` keeps the reference's fields; ``unknown_trip_whiles`` is always 0
(eager Python loops have no trip counts to miss).  ``kernel_calls`` counts
the kernel ops' calls by name, so a record shows which kernels its step
went through.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.work import op_work

# functional collectives (what DTensor's redistributions issue) -> the
# reference's HLO collective names
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}

# ops that move no data: results alias their input, or carry only metadata
_FREE = {
    "detach", "alias", "lift_fresh", "_local_scalar_dense", "empty",
    "empty_strided", "empty_like", "device", "dim", "sym_size", "sym_stride",
    "sym_numel", "sym_storage_offset", "is_same_size", "wait_tensor",
}

_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "logsumexp", "prod", "var",
    "std", "norm", "linalg_vector_norm", "argmax", "argmin", "cumsum",
    "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data", "sort", "topk", "any", "all",
}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)  # raw tensor bytes
    coll_wire: float = 0.0            # ring-model wire bytes
    convert_bytes: float = 0.0        # dtype conversions (inside ``bytes``)
    unknown_trip_whiles: int = 0
    dot_flops: float = 0.0            # matrix products (inside ``flops``)
    coll_wire_by_axis: Dict[str, float] = field(default_factory=dict)  # mesh axis -> wire
    kernel_calls: Dict[str, int] = field(default_factory=dict)  # repro_torch op -> calls

    def add(self, other: "Cost", scale: float = 1.0) -> None:
        self.flops += scale * other.flops
        self.bytes += scale * other.bytes
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + scale * v
        self.coll_wire += scale * other.coll_wire
        self.convert_bytes += scale * other.convert_bytes
        self.unknown_trip_whiles += other.unknown_trip_whiles
        self.dot_flops += scale * other.dot_flops
        for a, v in other.coll_wire_by_axis.items():
            self.coll_wire_by_axis[a] = self.coll_wire_by_axis.get(a, 0.0) + scale * v
        for a, n in other.kernel_calls.items():
            self.kernel_calls[a] = self.kernel_calls.get(a, 0) + n


def tensor_bytes(t: torch.Tensor) -> float:
    """Bytes of a tensor's elements (a local shard's, for a DTensor's local
    tensor)."""
    return float(t.numel() * t.element_size())


def tensor_elems(t: torch.Tensor) -> float:
    return float(t.numel())


def _collective_cost(kind: str, in_bytes: float, out_bytes: float, g: int
                     ) -> Tuple[str, float, float]:
    """(kind, tensor_bytes, wire_bytes) under the reference's ring model:
    all-reduce moves 2(g-1)/g of its input, all-gather (g-1)/g of its output,
    reduce-scatter and all-to-all (g-1)/g of their input (the larger side
    for all-to-all), a permute or broadcast its whole tensor."""
    frac = (g - 1) / g if g > 1 else 0.0
    if kind == "all-reduce":
        return kind, in_bytes, 2.0 * in_bytes * frac
    if kind == "all-gather":
        return kind, out_bytes, out_bytes * frac
    if kind == "reduce-scatter":
        return kind, in_bytes, in_bytes * frac
    if kind == "all-to-all":
        return kind, max(in_bytes, out_bytes), max(in_bytes, out_bytes) * frac
    return kind, max(in_bytes, out_bytes), max(in_bytes, out_bytes)


def _group_ranks(pg) -> Tuple[int, ...]:
    import torch.distributed as dist

    return tuple(sorted(dist.get_process_group_ranks(pg)))


def _group(args) -> Tuple[Tuple[int, ...], int]:
    """A functional collective's group ranks (from its group name, the last
    string argument; a reduction's op name comes first) and size."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in args if isinstance(a, str)]
    if not names:
        return (), 1
    pg = _resolve_process_group(names[-1])
    return _group_ranks(pg), pg.size()


def _in_shape_inference() -> bool:
    """Whether DTensor is running an op on global-shape fake tensors only to
    infer its output's metadata (not work any rank does)."""
    f = sys._getframe(2)
    for _ in range(16):
        if f is None:
            return False
        if f.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        f = f.f_back
    return False


def _flat(args, kwargs) -> List[Any]:
    """The op's arguments, one level of lists and tuples opened (an aten
    op's tensors sit no deeper)."""
    out: List[Any] = []
    for a in (*args, *kwargs.values()):
        if type(a) in (list, tuple):
            out.extend(a)
        else:
            out.append(a)
    return out


class CostCounter(TorchDispatchMode):
    """The dispatch mode behind :func:`analyze_step`: accumulates
    :attr:`cost` over the local ops it sees.  With ``mesh``, wire bytes are
    also kept per mesh axis (``coll_wire_by_axis``; a group that is no
    single axis counts under ``"g<size>"``)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.cost = Cost()
        self._axes: Dict[Tuple[int, ...], str] = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axes[_group_ranks(mesh.get_group(i))] = name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat = _flat(args, kwargs)
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented          # let DTensor run the local ops
        out = func(*args, **kwargs)
        if not _in_shape_inference():
            self._count(func, args, kwargs, flat, out)
        return out

    def _count(self, func, args, kwargs, flat, out) -> None:
        name = func.overloadpacket.__name__
        ns = func.namespace
        tin = [a for a in flat if isinstance(a, torch.Tensor)]
        touts = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        c = self.cost
        if ns == "_c10d_functional" and name in _COLLECTIVES:
            ranks, g = _group(args)
            kind, tb, wb = _collective_cost(_COLLECTIVES[name],
                                            sum(map(tensor_bytes, tin)),
                                            sum(map(tensor_bytes, touts)), g)
            c.coll_bytes[kind] = c.coll_bytes.get(kind, 0.0) + tb
            c.coll_wire += wb
            axis = self._axes.get(ranks, f"g{g}")
            c.coll_wire_by_axis[axis] = c.coll_wire_by_axis.get(axis, 0.0) + wb
            return
        if name in _FREE or ns == "prim" or func.is_view:
            return
        nbytes = sum(map(tensor_bytes, tin)) + sum(
            tensor_bytes(o) for o in touts if not any(o is t for t in tin))
        c.bytes += nbytes
        if name in ("_to_copy", "to") and tin and touts and tin[0].dtype != touts[0].dtype:
            c.convert_bytes += nbytes
        packet = func.overloadpacket
        if ns == "repro_torch":
            given = len(args)
            vals = [*args] + [kwargs[a.name] for a in func._schema.arguments[given:]
                              if a.name in kwargs]
            f, dot = op_work(name, vals)
            c.flops += f
            c.dot_flops += dot
            c.kernel_calls[f"{ns}::{name}"] = c.kernel_calls.get(f"{ns}::{name}", 0) + 1
        elif packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
            c.dot_flops += f
            c.flops += f
        elif name in _REDUCTIONS:
            c.flops += tensor_elems(tin[0]) if tin else 0.0
        elif torch.Tag.pointwise in func.tags:
            c.flops += sum(map(tensor_elems, touts))


def analyze_step(fn: Callable[..., Any], *args, mesh=None, **kwargs) -> Cost:
    """The per-device :class:`Cost` of one call ``fn(*args, **kwargs)``
    (its outputs are dropped), wire bytes per axis of ``mesh`` when given.
    Run it on DTensors over meta shards (the dry-run) to count without
    computing."""
    counter = CostCounter(mesh)
    with counter:
        fn(*args, **kwargs)
    return counter.cost
