"""Roofline analysis from dry-run records, for NVIDIA H100 SXM cards.

Per (arch x shape x mesh):
    compute term    = flops_per_device / PEAK_FLOPS                (dense bf16)
    memory term     = bytes_per_device / HBM_BW
    collective term = sum over mesh axes of the axis's wire bytes per device
                      / NVLINK_BW when the axis's groups fit in one 8-GPU
                      NVLink domain, else / IB_BW

plus MODEL_FLOPS = 6*N(_active)*D (dense/MoE) and the useful-compute ratio
MODEL_FLOPS / (flops_per_device * chips).  The per-device numbers come from
:mod:`repro_torch.launch.hlo_cost` (counted op by op on the local shards; the
bytes are an eager, unfused count).  The constants are datasheet figures,
not measurements.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from repro_torch.configs import get_model_config, get_shape

# NVIDIA H100 80GB HBM3 (SXM5) datasheet figures, per GPU:
PEAK_FLOPS = 989e12        # dense bf16 tensor-core FLOP/s (1979 TF with sparsity)
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 450e9          # NVLink 4 bytes/s per direction (900 GB/s both ways)
IB_BW = 50e9               # one 400 Gb/s NDR InfiniBand port per GPU, bytes/s
NVLINK_DOMAIN = 8          # GPUs per NVLink domain (one HGX H100 board)


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops_total: float
    hlo_flops_total: float
    useful_ratio: float
    note: str = ""

    def as_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic 'useful' FLOPs for the whole step (all chips)."""
    return _model_flops(get_model_config(arch), get_shape(shape_name))


def _record_model_flops(rec: Dict[str, Any]) -> float:
    """:func:`model_flops` of a record: of the smoke config for a smoke
    record, at the depth, batch and length the dry-run cut (``rec["cut"]``)."""
    cut = rec.get("cut") or {}
    cfg = get_model_config(rec["arch"], smoke=rec.get("smoke", False))
    shape = get_shape(rec["shape"])
    if "n_layers" in cut:
        cfg = dataclasses.replace(cfg, n_layers=cut["n_layers"])
    shape = dataclasses.replace(shape, global_batch=cut.get("global_batch", shape.global_batch),
                                seq_len=cut.get("seq_len", shape.seq_len))
    return _model_flops(cfg, shape)


def _model_flops(cfg, shape) -> float:
    n_act = cfg.active_param_count()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    # decode: one token per sequence + KV-cache attention reads (flops-wise
    # the cache dot products: 2 * 2 * L * kv_dim * ctx per sequence)
    ctx = min(shape.seq_len, cfg.window) if (cfg.window and cfg.attention in
                                             ("swa", "hybrid")) else shape.seq_len
    attn = 0.0
    if cfg.attention != "none" and cfg.n_heads:
        attn = 4.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * ctx
    return shape.global_batch * (2.0 * n_act + attn)


def axis_link_bw(mesh_axes: Dict[str, int], axis: str) -> float:
    """The per-GPU wire rate of ``axis``'s groups on a row-major mesh: NVLink
    when a group's ranks lie within one NVLink domain, InfiniBand otherwise
    (and for a group that is no single axis)."""
    if axis not in mesh_axes:
        return IB_BW
    names = list(mesh_axes)
    stride = math.prod(mesh_axes[n] for n in names[names.index(axis) + 1:])
    return NVLINK_BW if mesh_axes[axis] * stride <= NVLINK_DOMAIN else IB_BW


def collective_seconds(hlo: Dict[str, Any], mesh_axes: Dict[str, int]) -> float:
    by_axis = hlo.get("collective_wire_bytes_by_axis")
    if by_axis is None:
        return hlo["collective_wire_bytes"] / IB_BW
    return sum(w / axis_link_bw(mesh_axes, a) for a, w in by_axis.items())


def row_from_record(rec: Dict[str, Any]) -> Optional[RooflineRow]:
    if rec.get("status") != "ok":
        return None
    hlo = rec["hlo"]
    chips = rec["chips"]
    compute_s = hlo["flops_per_device"] / PEAK_FLOPS
    memory_s = hlo["bytes_per_device"] / HBM_BW
    coll_s = collective_seconds(hlo, rec.get("mesh_axes", {}))
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = _record_model_flops(rec)
    hlo_total = hlo["flops_per_device"] * chips
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"], chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=coll_s,
        dominant=dominant, model_flops_total=mf, hlo_flops_total=hlo_total,
        useful_ratio=mf / hlo_total if hlo_total else 0.0,
    )


_SUGGEST = {
    "compute": ("reduce redundant FLOPs (remat policy, masked-block skipping, "
                "MoE dispatch) or grow per-GPU work to amortize"),
    "memory": ("fuse the eager ops (the count is unfused), shrink the working "
               "set (smaller cache dtype, activation layout) or raise arithmetic "
               "intensity with larger blocks"),
    "collective": ("re-shard to cut resharding (2D sharding of the dominant "
                   "weight, all-gather -> reduce-scatter conversion, overlap "
                   "collectives with compute) or keep the busiest axis inside "
                   "one NVLink domain"),
}


def render_table(rows: List[RooflineRow]) -> str:
    hdr = (f"| {'arch':26s} | {'shape':11s} | {'mesh':8s} | compute(s) | "
           f"memory(s) | collective(s) | dominant | useful |")
    sep = "|" + "-" * (len(hdr) - 2) + "|"
    out = [hdr, sep]
    for r in rows:
        out.append(
            f"| {r.arch:26s} | {r.shape:11s} | {r.mesh:8s} | {r.compute_s:10.4f} | "
            f"{r.memory_s:9.4f} | {r.collective_s:13.4f} | {r.dominant:8s} | "
            f"{r.useful_ratio:6.3f} |")
    return "\n".join(out)


def suggestion(row: RooflineRow) -> str:
    return _SUGGEST[row.dominant]


def report_from_json(path: str) -> List[RooflineRow]:
    with open(path) as f:
        recs = json.load(f)
    rows = []
    for rec in recs:
        r = row_from_record(rec)
        if r is not None:
            rows.append(r)
    return rows
