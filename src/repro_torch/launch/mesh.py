"""Production mesh definitions as ``torch.distributed`` DeviceMeshes.

The reference's TPU v5e pod shapes, kept so that the sharding rules and
specs compare one to one: ``(16, 16)`` over ``("data", "model")``, or
``(2, 16, 16)`` over ``("pod", "data", "model")``.  A mesh spans the
process's default group, which must hold exactly the mesh's ranks; the
dry-run (:mod:`repro_torch.launch.dryrun`) builds the production meshes over
a fake group, a real run over one rank per card.

Defined as functions, so importing this module starts no group.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch import DeviceLike, resolve_device


def ensure_process_group(device: DeviceLike = None) -> None:
    """Start a one-rank default group where none exists, so that a ``(1, 1)``
    mesh works in a plain process: NCCL for the card (the default), gloo for
    ``device="cpu"``.  The group keeps its rendezvous in a ``HashStore``, so
    it opens no port."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mk(shape: Tuple[int, ...], axes: Tuple[str, ...], device: DeviceLike) -> DeviceMesh:
    dev = resolve_device(device)
    if math.prod(shape) == 1:
        ensure_process_group(dev)
    if not dist.is_initialized() or dist.get_world_size() != math.prod(shape):
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"a {shape} mesh needs a default group of {math.prod(shape)} "
                           f"ranks; this process has {have}")
    if dev.type == "cuda" and dist.get_backend() != "fake":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device: DeviceLike = None
                         ) -> DeviceMesh:
    """16x16 = 256 ranks per pod; ``multi_pod`` adds a leading 2-pod axis."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mk(shape, axes, device)


def make_host_mesh(device: DeviceLike = None) -> DeviceMesh:
    """One-rank mesh with the same axis names (the card unless ``device``
    says otherwise); starts a one-rank group where none exists."""
    return _mk((1, 1), ("data", "model"), device)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device: DeviceLike = None
              ) -> DeviceMesh:
    """Any mesh over the default group, e.g. ``(1, 2)`` over two ranks."""
    return _mk(tuple(shape), tuple(axes), device)


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size.  Takes a DeviceMesh, a dict of sizes, or the
    reference's mesh duck type (``axis_names`` and ``devices.shape``), so the
    rules and specs can be computed for a mesh no process group holds."""
    if isinstance(mesh, dict):
        return dict(mesh)
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def mesh_label(mesh: Any) -> str:
    """``"16x16"``: the mesh's shape as the dry-run records it."""
    return "x".join(str(s) for s in mesh_axis_sizes(mesh).values())


def destroy_process_group() -> Optional[str]:
    """End the default group, if any; returns its backend."""
    if not dist.is_initialized():
        return None
    backend = dist.get_backend()
    dist.destroy_process_group()
    return backend
