"""Multi-node dry-run: prove every (architecture x input shape x mesh)
combination partitions on the production mesh, and count what one step
costs a device.

The mesh spans a *fake* process group of the mesh's world size (256 ranks,
or 512 with ``--multi-pod``), so collectives run nowhere, and the step runs
on DTensors over ``meta`` local shards of this rank's shapes, so nothing is
computed or allocated (DTensor infers each op's global output under its own
fake-tensor mode; meta local shards run the step about twice as fast as
fake ones, with the same FLOP and collective counts).  For each combination it builds the logical rules
and the parameter, optimizer, batch and decode-state specs
(:mod:`repro_torch.launch.sharding`), places the shape stand-ins of
:mod:`repro_torch.launch.steps` by them, and runs one train step (AdamW
update included), prefill step or decode step under
:func:`~repro_torch.models.sharding.use_logical_rules`, with
:class:`~repro_torch.launch.hlo_cost.CostCounter` counting the local ops and
collectives.  The outputs are laid out by the reference's ``out_shardings``
specs inside the counted region.

The fake group is the default group, and a process has only one: run the
dry-run in a process of its own.  ``torch.testing._internal`` holds the fake
group's store; it is a test utility of PyTorch, not a public API.

``impl`` is the route the step counts, as the reference's ``impl``:

* ``"blocked"`` (the default, as in the reference): attention's chunked
  online softmax (:mod:`repro_torch.models.flash_xla`) in plain tensor ops,
  and the SSM mixers' plain routes (Hymba's Mamba scan a per-token loop,
  RWKV6's chunkwise WKV), every op counted unfused;
* ``"naive"``: attention's whole (S, S) scores, the same SSM routes;
* ``"flash"`` (the reference's ``"pallas"``): prefill attention through
  ``repro_torch::flash_attention`` and the SSM mixers, prefill and decode,
  through ``repro_torch::selective_scan`` and ``repro_torch::wkv6``, the
  kernel ops the card runs.  On meta shards their fake implementations
  give the outputs' shapes (and refuse what the kernels would refuse); the
  counter books each op's work by its formula
  (:mod:`repro_torch.kernels.work`) and its operand and result bytes.  The
  kernels have no backward, so a ``train`` combination under ``"flash"`` is
  ``skipped`` with that reason.

Usage:
    python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out build/dryrun.json
    python -m repro_torch.launch.dryrun --all --multi-pod
    python -m repro_torch.launch.dryrun --all --smoke --mesh 2x4 --device cpu
    python -m repro_torch.launch.dryrun --arch hymba-1.5b --shape prefill_32k --impl flash
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import os
import time
import traceback
import warnings
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import INPUT_SHAPES, ShapeConfig, get_model_config, get_shape, list_archs
from repro_torch.fl._tree import tree_leaves_with_path
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.hlo_cost import CostCounter
from repro_torch.launch.mesh import make_mesh, mesh_axis_sizes, mesh_label
from repro_torch.launch.roofline import row_from_record
from repro_torch.launch.sharding import (
    P,
    build_rules,
    decode_state_specs,
    distribute_params,
    param_specs,
)
from repro_torch.models.sharding import use_logical_rules

IMPLS = ("blocked", "naive", "flash")
NO_BACKWARD = ("impl='flash' has no train step: the flash_attention, mamba and "
               "rwkv6 kernels have no backward")
# what the reference's record holds and the port's cannot measure
NOT_MEASURED = ("memory.temp_size_in_bytes", "memory.generated_code_size_in_bytes",
                "memory.alias_size_in_bytes", "lower_s", "compile_s", "xla_cost")


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; have {IMPLS}")


def skip_reason(cfg, shape) -> Optional[str]:
    if shape.name.startswith("long_500k") and not cfg.supports_long_context():
        return ("full quadratic attention at 524k context: skipped per "
                "assignment rules (sub-quadratic archs only)")
    return None


def smoke_shape(shape: ShapeConfig) -> ShapeConfig:
    """An input shape cut for a smoke config: the same mode, 64 positions
    (4096 for the long-context decode), batch 8 (1 for it)."""
    long = shape.name.startswith("long_500k")
    return ShapeConfig(shape.name + "-smoke", 4096 if long else 64, 1 if long else 8,
                       shape.mode)


def _batch_sharding(cfg, shape, mesh, rules) -> Dict[str, P]:
    ba = rules["batch"]
    specs: Dict[str, P] = {
        "tokens": P(ba, None),
        "labels": P(ba, None),
    }
    if cfg.frontend is not None:
        specs["frontend_embeds"] = P(ba, None, None)
    return specs


def fake_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device: DeviceLike = None):
    """A DeviceMesh over a fake default group of ``prod(shape)`` ranks (this
    process is rank 0); a default group of another size is replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    n = math.prod(shape)
    if dist.is_initialized() and (dist.get_backend() != "fake" or dist.get_world_size() != n):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    return make_mesh(shape, axes, device)


def production_mesh_shape(multi_pod: bool) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


_COUNTER_CHECKED: Dict[str, Dict[str, float]] = {}


def counter_check(mesh) -> Dict[str, float]:
    """Hold the cost counter to a sum it must get exactly, once per mesh and
    process, before any step runs (DTensor caches its shape inference, so
    the first call is the one that would count it): a column-parallel then
    row-parallel MLP on meta shards, whose matrix products cost a device
    ``2 * 2*(M/data)*K*(N/model)`` FLOPs.  A counter that also counts
    DTensor's global-shape inference ops (a PyTorch release that moved
    them where :func:`~repro_torch.launch.hlo_cost._in_shape_inference`
    does not look) reads more, and this raises."""
    label = mesh_label(mesh)
    if label not in _COUNTER_CHECKED:
        ax = mesh_axis_sizes(mesh)
        d, m = ax.get("data", 1), ax.get("model", 1)
        rows, k, n = 2 * d, 64, 8 * m
        meta = {"x": torch.empty(rows, k, device="meta"),
                "w1": torch.empty(k, n, device="meta"),
                "w2": torch.empty(n, k, device="meta")}
        specs = {"x": P("data", None), "w1": P(None, "model"), "w2": P("model", None)}
        t = distribute_params(meta, mesh, specs, local_device="meta")
        counter = CostCounter(mesh)
        with counter:
            (torch.relu(t["x"] @ t["w1"]) @ t["w2"]).redistribute(mesh, t["x"].placements)
        want = 2.0 * 2 * (rows // d) * k * (n // m)
        got = counter.cost.dot_flops
        if got != want:
            raise RuntimeError(
                f"the cost counter read {got:.0f} FLOPs of a sharded MLP where a device "
                f"does {want:.0f} (torch {torch.__version__}): it counts DTensor's "
                "global-shape inference ops")
        _COUNTER_CHECKED[label] = {"dot_flops": got, "expected": want}
    return _COUNTER_CHECKED[label]


def _local_bytes(tree) -> int:
    total = 0
    for _, t in tree_leaves_with_path(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            total += local.numel() * local.element_size()
    return total


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            impl: str = "blocked", moe_dispatch: Optional[str] = None,
            seq_shard: bool = False, fsdp_on_output: bool = False,
            weights_tp_only: bool = False,
            extra_rules: Optional[Dict[str, Any]] = None,
            cfg_overrides: Optional[Dict[str, Any]] = None,
            smoke: bool = False, mesh_shape: Optional[Tuple[int, ...]] = None,
            batch: Optional[int] = None, seq: Optional[int] = None,
            device: DeviceLike = None) -> Dict[str, Any]:
    """One combination's record: ``status`` ok / skipped / error, the local
    argument and output sizes, the per-device cost (``hlo``) and
    ``seconds``.  ``smoke`` runs the arch's smoke config at
    :func:`smoke_shape`; ``mesh_shape`` replaces the production mesh (same
    axis names, innermost ``model``); ``batch`` and ``seq`` replace the
    shape's global batch and length (its mode stays)."""
    _check_impl(impl)
    cfg = get_model_config(arch, smoke=smoke)
    shape = get_shape(shape_name)
    if smoke:
        shape = smoke_shape(shape)
    if batch or seq:
        shape = dataclasses.replace(shape, name=f"{shape.name}-b{batch}-s{seq}",
                                    global_batch=batch or shape.global_batch,
                                    seq_len=seq or shape.seq_len)
    if mesh_shape is None:
        mesh_shape, axes = production_mesh_shape(multi_pod)
    else:
        axes = ("pod", "data", "model")[-len(mesh_shape):]
    mesh = fake_mesh(tuple(mesh_shape), axes, device)
    ax = mesh_axis_sizes(mesh)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    if cfg.moe is not None:
        # align MoE dispatch groups with the (pod x) data axis
        groups = ax.get("data", 1) * ax.get("pod", 1)
        moe = dataclasses.replace(cfg.moe, n_groups=groups,
                                  **({"dispatch": moe_dispatch} if moe_dispatch else {}))
        cfg = dataclasses.replace(cfg, moe=moe)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_label(mesh),
        "mesh_axes": ax, "chips": math.prod(mesh_shape), "mode": shape.mode,
        "impl": impl, "smoke": smoke, "not_measured": list(NOT_MEASURED),
    }
    cut = {"n_layers": cfg.n_layers} if "n_layers" in (cfg_overrides or {}) else {}
    if smoke or batch or seq:
        cut.update(global_batch=shape.global_batch, seq_len=shape.seq_len)
    if cut:
        rec["cut"] = cut
    sk = skip_reason(cfg, shape)
    if not sk and impl == "flash" and shape.mode == "train":
        sk = NO_BACKWARD
    if sk:
        rec["status"] = "skipped"
        rec["reason"] = sk
        return rec

    rules = build_rules(cfg, mesh, shape, seq_shard=seq_shard)
    if extra_rules:
        rules.update(extra_rules)
    t0 = time.time()
    try:
        rec["counter_check"] = counter_check(mesh)
        step, structs, in_specs, out_specs = _build(cfg, shape, mesh, rules, impl,
                                                    fsdp_on_output, weights_tp_only)
        args = tuple(distribute_params(a, mesh, s, local_device="meta")
                     for a, s in zip(structs, in_specs))
        counter = CostCounter(mesh)
        with use_logical_rules(mesh, rules), counter:
            out = step(*args)
            out = tuple(distribute_params(o, mesh, s) for o, s in zip(out, out_specs))
        rec["memory"] = {"argument_size_in_bytes": _local_bytes(args),
                         "output_size_in_bytes": _local_bytes(out)}
        cost = counter.cost
        rec["hlo"] = {
            "flops_per_device": cost.flops,
            "dot_flops_per_device": cost.dot_flops,
            "bytes_per_device": cost.bytes,
            "convert_bytes_per_device": cost.convert_bytes,
            "collective_bytes": {k: v for k, v in sorted(cost.coll_bytes.items())},
            "collective_wire_bytes": cost.coll_wire,
            "collective_wire_bytes_by_axis": dict(sorted(cost.coll_wire_by_axis.items())),
            "unknown_trip_whiles": cost.unknown_trip_whiles,
            "kernel_calls": dict(sorted(cost.kernel_calls.items())),
        }
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["seconds"] = time.time() - t0
    return rec


def _build(cfg, shape, mesh, rules, impl, fsdp_on_output, weights_tp_only):
    """(step, the inputs' stand-ins, their specs, the outputs' specs) for
    ``shape.mode``; the stand-ins are meta tensors."""
    ps = steps_lib.params_struct(cfg)
    if shape.mode == "train":
        optimizer = steps_lib.make_optimizer()
        step = steps_lib.make_train_step(cfg, optimizer, impl=impl)
        pmode = "decode" if weights_tp_only else "train"
        pspec = param_specs(cfg, ps, mesh, pmode, fsdp_on_output=fsdp_on_output)
        ospec = {"mu": pspec, "nu": pspec, "step": P()}
        bspec = _batch_sharding(cfg, shape, mesh, rules)
        metrics_spec = {"loss": P(), "xent": P(), "aux": P()}
        args = (ps, steps_lib.opt_struct(cfg, optimizer), steps_lib.batch_specs(cfg, shape))
        return step, args, (pspec, ospec, bspec), (pspec, ospec, metrics_spec)
    pspec = param_specs(cfg, ps, mesh, "decode")
    logits_spec = P(rules["batch"], rules["vocab"])
    inputs = steps_lib.input_specs(cfg, shape)
    if shape.mode == "prefill":
        step = steps_lib.make_prefill_step(cfg, shape, impl=impl)
        bspec = _batch_sharding(cfg, shape, mesh, rules)
        bspec.pop("labels")
        sspec = decode_state_specs(cfg, steps_lib.decode_state_struct(cfg, shape), mesh, shape)
        return step, (ps, inputs["batch"]), (pspec, bspec), (logits_spec, sspec)
    step = steps_lib.make_serve_step(cfg, impl=impl)
    sspec = decode_state_specs(cfg, inputs["state"], mesh, shape)
    return (step, (ps, inputs["state"], inputs["token"]),
            (pspec, sspec, P(rules["batch"])), (logits_spec, sspec))


def _quiet() -> None:
    """DTensor warns on every multi-axis redistribution; the dry-run counts
    them instead."""
    warnings.filterwarnings("ignore")
    for name in ("torch.distributed.tensor", "torch.distributed", "torch._logging"):
        logging.getLogger(name).setLevel(logging.ERROR)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="an arch, or several joined by commas")
    ap.add_argument("--shape", default=None,
                    help="an input shape, or several joined by commas (default: all)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--impl", default="blocked", choices=IMPLS,
                    help="the route counted: blocked (default) and naive run "
                         "attention and the SSM mixers as plain tensor ops, "
                         "flash sends them through the kernel ops (prefill and "
                         "decode; train is skipped, the kernels have no backward)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at cut shapes (a quick check)")
    ap.add_argument("--mesh", default=None,
                    help="a mesh shape in place of the production one, e.g. 2x4")
    ap.add_argument("--device", default=None,
                    help="the mesh's device type (default: the card)")
    ap.add_argument("--layers", type=int, default=None, help="cut the depth")
    ap.add_argument("--batch", type=int, default=None, help="replace the global batch")
    ap.add_argument("--seq", type=int, default=None, help="replace the sequence length")
    args = ap.parse_args(argv)
    _quiet()
    resolve_device(args.device)
    mesh_shape = tuple(int(x) for x in args.mesh.split("x")) if args.mesh else None

    runs = []
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    archs = list_archs() if args.all else args.arch.split(",")
    shapes = ([s.name for s in INPUT_SHAPES] if args.all or args.shape is None
              else args.shape.split(","))
    combos = [(a, s) for a in archs for s in shapes]
    for mp in meshes:
        for arch, shape in combos:
            rec = run_one(arch, shape, multi_pod=mp, impl=args.impl, smoke=args.smoke,
                          mesh_shape=mesh_shape, batch=args.batch, seq=args.seq,
                          cfg_overrides={"n_layers": args.layers} if args.layers else None,
                          device=args.device)
            status = rec["status"]
            extra = ""
            if status == "ok":
                row = row_from_record(rec)
                extra = (f"{rec['seconds']:.1f}s flops/dev={rec['hlo']['flops_per_device']:.3e} "
                         f"bytes/dev={rec['hlo']['bytes_per_device']:.3e} "
                         f"coll={rec['hlo']['collective_wire_bytes']:.3e}B "
                         f"roofline compute={row.compute_s:.4f}s memory={row.memory_s:.4f}s "
                         f"collective={row.collective_s:.4f}s ({row.dominant})")
            elif status == "error":
                extra = rec["error"]
            print(f"[{rec['mesh']}] {arch:26s} {shape:12s} {status:8s} {extra}",
                  flush=True)
            runs.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
        print(f"wrote {args.out}")
    if dist.is_initialized():
        dist.destroy_process_group()
    n_err = sum(r["status"] == "error" for r in runs)
    if n_err:
        raise SystemExit(f"{n_err} dry-run failures")


if __name__ == "__main__":
    main()
