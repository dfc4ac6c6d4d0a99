"""Round-execution engine: RoundPlan + pluggable ClientExecutors.

* :class:`RoundPlan` — the stage structure of one FL round (probe → select
  → complete), emitted per policy by :func:`build_round_plan`.  Probing
  policies (FedRank) get a 1-epoch probe stage over ``policy.probe_set(ctx)``
  whose survivors complete the remaining ``l_ep - 1`` epochs; non-probing
  baselines get an empty probe stage and a full ``l_ep``-epoch completion.
* :class:`SequentialExecutor` — the reference semantics: one
  :func:`repro_torch.fl.client.local_train` call per client, in order.
* :class:`VmappedExecutor` — the cohort-batched path: clients grouped into
  (padded size, epochs) buckets, each bucket one
  :func:`repro_torch.fl.client.make_parallel_local_train` call over the
  client axis, with the same per-client shuffle orders, so its results
  match :class:`SequentialExecutor`'s within fp32 rounding.
* :class:`AsyncDispatchExecutor` — the ``"async"`` registry alias: it
  selects the asynchronous engine and delegates each wave's client work to
  its ``inner`` executor.

Executors are looked up by name (``FLConfig.executor``): ``"sequential"``,
``"vmapped"`` and ``"async"``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.fl._tree import tree_device, tree_index, tree_map, tree_stack
from repro_torch.fl.client import (
    _bucket_geometry,
    _pad_bucket,
    local_train,
    make_parallel_local_train,
)
from repro_torch.obs.profiling import span, timed_call

Params = Any


@dataclass(frozen=True)
class RoundPlan:
    """Stage structure of one FL round.

    probe stage      — every device in ``probe_ids`` runs ``probe_epochs``
                       local epochs from the global params and reports its
                       loss (empty ``probe_ids`` skips the stage);
    select           — the policy cuts the cohort down to K survivors;
    completion stage — survivors run ``completion_epochs`` further epochs
                       (resuming from their probed params when probed).
    """

    probe_ids: np.ndarray
    probe_epochs: int
    completion_epochs: int

    @property
    def has_probe(self) -> bool:
        return len(self.probe_ids) > 0 and self.probe_epochs > 0


def build_round_plan(policy, ctx, l_ep: int) -> RoundPlan:
    """Adapt a SelectionPolicy into a RoundPlan: its ``needs_probing``
    capability picks one of the paper's two round shapes."""
    if getattr(policy, "needs_probing", False):
        probe_ids = np.asarray(policy.probe_set(ctx), dtype=np.int64)
        return RoundPlan(probe_ids, probe_epochs=1, completion_epochs=l_ep - 1)
    return RoundPlan(np.empty(0, np.int64), probe_epochs=0,
                     completion_epochs=l_ep)


@dataclass(frozen=True)
class ClientRequest:
    """One client's local-training work item for a stage."""

    client_id: int
    x: Any                                  # (n, dim) shard, numpy or tensor
    y: Any                                  # (n,) labels
    epochs: int
    seed: int
    init_params: Optional[Params] = None    # None => start from global params


@dataclass
class ExecutionResult:
    """Per-client outputs of a stage, keyed by client id."""

    params: Dict[int, Params] = field(default_factory=dict)
    losses: Dict[int, np.ndarray] = field(default_factory=dict)


# Seed strides for per-client local-training RNG: stage seeds are
# ``cfg.seed + stride * round + client_id`` so probe and completion stages
# of the same round never collide (the reference's values).
PROBE_SEED_STRIDE = 1000
COMPLETE_SEED_STRIDE = 2000


def build_requests(ids: Sequence[int], client_data: Callable[[int], tuple],
                   epochs: int, *, seed: int, round_idx: int, stride: int,
                   init_params: Optional[Dict[int, Params]] = None
                   ) -> List[ClientRequest]:
    """One :class:`ClientRequest` per client id; ``client_data(i) -> (x, y)``
    supplies each shard and ``init_params`` (id -> params) overrides the
    global starting point for clients resuming from probed state."""
    init = init_params or {}
    return [ClientRequest(int(i), *client_data(int(i)), epochs=epochs,
                          seed=seed + stride * round_idx + int(i),
                          init_params=init.get(int(i)))
            for i in ids]


class ClientExecutor(Protocol):
    name: str

    def run(self, task, global_params: Params,
            requests: Sequence[ClientRequest], *, lr: float,
            batch_size: int, prox_mu: float) -> ExecutionResult: ...


class SequentialExecutor:
    """Reference semantics: one ``local_train`` call per client, in order."""

    name = "sequential"

    def run(self, task, global_params, requests, *, lr, batch_size, prox_mu
            ) -> ExecutionResult:
        out = ExecutionResult()
        for req in requests:
            init = req.init_params if req.init_params is not None else global_params
            p, losses = local_train(task, init, req.x, req.y,
                                    epochs=req.epochs, lr=lr,
                                    batch_size=batch_size, prox_mu=prox_mu,
                                    seed=req.seed)
            out.params[req.client_id] = p
            out.losses[req.client_id] = losses
        return out


@functools.lru_cache(maxsize=256)
def _bucket_step(task, batch_size: int, n_batches: int, epochs: int,
                 prox_mu: float, stacked_params: bool):
    """The whole-bucket step, cached per (task, geometry, epochs)."""
    return make_parallel_local_train(task, batch_size=batch_size,
                                     n_batches=n_batches, epochs=epochs,
                                     prox_mu=prox_mu,
                                     stacked_params=stacked_params)


class VmappedExecutor:
    """The cohort's local training as one batched step per bucket.

    Clients are grouped into (padded size, epochs) buckets; each bucket is
    one vmapped call over the client axis on the global params' device, with
    the host shuffle orders (``np.random.default_rng(req.seed)``, drawn as
    :func:`~repro_torch.fl.client.local_train` draws them) uploaded once as
    gather indices.  A request with ``epochs <= 0`` passes its init through.
    Each client's params are its slice of the stacked result (a view, on the
    device); the losses come to the host in one copy per bucket.

    ``mesh`` (a DeviceMesh with a ``data`` axis, see
    :mod:`repro_torch.launch.mesh`) shards the client axis over ``data``, as
    the reference does: each bucket is padded to a multiple of the axis size
    with duplicates of its last client (their results are dropped), each
    rank runs its contiguous slice of the padded clients through the same
    bucket step, and an ``all_gather`` over the axis gives every rank every
    client's params and losses.  Ranks along other axes repeat the work of
    their ``data`` coordinate.
    """

    name = "vmapped"

    def __init__(self, mesh=None):
        self.mesh = mesh

    def run(self, task, global_params, requests, *, lr, batch_size, prox_mu
            ) -> ExecutionResult:
        out = ExecutionResult()
        buckets: Dict[tuple, List[ClientRequest]] = {}
        for req in requests:
            if req.epochs <= 0:
                out.params[req.client_id] = (req.init_params
                                             if req.init_params is not None
                                             else global_params)
                out.losses[req.client_id] = np.zeros(0)
                continue
            cap, _, _ = _bucket_geometry(len(req.y), batch_size)
            buckets.setdefault((cap, req.epochs), []).append(req)
        for (cap, epochs), reqs in buckets.items():
            self._run_bucket(task, global_params, reqs, cap, epochs, out,
                             lr=lr, batch_size=batch_size, prox_mu=prox_mu)
        return out

    def _run_bucket(self, task, global_params, reqs, cap, epochs, out, *,
                    lr, batch_size, prox_mu):
        _, bs, nb = _bucket_geometry(cap, batch_size)
        take = nb * bs
        device = tree_device(global_params)
        stacked_init = any(req.init_params is not None for req in reqs)
        with span("inputs"):
            xs, ys, masks, perms = [], [], [], []
            for req in reqs:
                xpad, ypad, mask = _pad_bucket(torch.as_tensor(req.x, device=device),
                                               torch.as_tensor(req.y, device=device))
                xs.append(xpad)
                ys.append(ypad)
                masks.append(mask)
                rng = np.random.default_rng(req.seed)
                perms.append(np.stack([rng.permutation(cap)[:take]
                                       for _ in range(epochs)]))
            inits = [req.init_params if req.init_params is not None
                     else global_params for req in reqs] if stacked_init else None
            if self.mesh is not None:
                # pad the client axis to a multiple of the data axis (duplicates
                # of the last client, results dropped); this rank takes its slice
                n, r = self._data_axis()
                for lst in (xs, ys, masks, perms) + ((inits,) if stacked_init else ()):
                    lst.extend([lst[-1]] * ((-len(reqs)) % n))
                per = len(xs) // n
                lo, hi = r * per, (r + 1) * per
                xs, ys, masks, perms = xs[lo:hi], ys[lo:hi], masks[lo:hi], perms[lo:hi]
                inits = inits[lo:hi] if stacked_init else None
            if stacked_init:
                p0 = tree_stack(inits)
            else:
                # shared start (probe stage, plain rounds): the one dict is
                # broadcast inside the step, no K-fold copy
                p0 = global_params
            args = (p0, torch.stack(xs), torch.stack(ys), torch.stack(masks), float(lr),
                    torch.as_tensor(np.stack(perms), device=device))
        step = _bucket_step(task, bs, nb, epochs, float(prox_mu), stacked_init)
        # timed_call is a passthrough unless a profiler is active
        # (repro_torch.obs.profiling); then the bucket step is fenced and
        # charged per (cohort size, epochs) geometry
        stacked, ep_losses = timed_call(
            f"vmapped.bucket_step[k={len(reqs)},ep={epochs}]", step, *args)
        if self.mesh is not None:
            stacked, ep_losses = self._gather((stacked, ep_losses))
        # one device->host copy of the bucket's losses; each client's params
        # are a view of the stacked result (slicing launches nothing)
        ep_losses = ep_losses.double().cpu().numpy()
        for j, req in enumerate(reqs):
            out.params[req.client_id] = tree_index(stacked, j)
            out.losses[req.client_id] = ep_losses[j]


    def _data_axis(self):
        """(size of the mesh's ``data`` axis, this rank's coordinate on it)."""
        names = self.mesh.mesh_dim_names
        if "data" not in names:
            return 1, 0
        return self.mesh.size(names.index("data")), self.mesh.get_local_rank("data")

    def _gather(self, tree):
        """Every rank's slice of the client axis, concatenated in rank order
        over the ``data`` axis."""
        n, _ = self._data_axis()
        group = self.mesh.get_group("data") if "data" in self.mesh.mesh_dim_names else None

        def gather(t):
            parts = [torch.empty_like(t) for _ in range(n)]
            dist.all_gather(parts, t.contiguous(), group=group)
            return torch.cat(parts)

        return tree_map(gather, tree)


def executor_label(ex) -> str:
    """The executor doing the work, wrappers unwrapped: its registry ``name``
    with any ``inner`` delegate in brackets, e.g. ``"async[sequential]"``
    (what :class:`~repro_torch.fl.server.RoundResult` records)."""
    name = getattr(ex, "name", type(ex).__name__)
    inner = getattr(ex, "inner", None)
    if inner is not None:
        return f"{name}[{executor_label(inner)}]"
    return name


class AsyncDispatchExecutor:
    """Registry alias selecting the asynchronous engine.

    ``FLConfig(executor="async")`` is shorthand for ``FLConfig(mode="async")``:
    the server spots this executor's name and drives rounds through
    :class:`repro_torch.fl.async_engine.AsyncRoundEngine`.  Each dispatch
    wave's client work goes to ``inner`` (default
    :class:`SequentialExecutor`; ``inner="vmapped"`` runs each wave as one
    batched step per bucket).
    """

    name = "async"

    def __init__(self, inner=None, **kw):
        if inner is None or isinstance(inner, str):
            self.inner = make_executor(inner or "sequential", **kw)
        else:
            self.inner = inner

    def run(self, task, global_params, requests, *, lr, batch_size, prox_mu
            ) -> ExecutionResult:
        return self.inner.run(task, global_params, requests, lr=lr,
                              batch_size=batch_size, prox_mu=prox_mu)


_EXECUTORS: Dict[str, Callable[..., ClientExecutor]] = {}


def register_executor(name: str, factory: Callable[..., ClientExecutor]) -> None:
    """Register an executor factory under ``name``; a name already
    registered raises ``ValueError``."""
    if name in _EXECUTORS:
        raise ValueError(f"executor {name!r} already registered")
    _EXECUTORS[name] = factory


def make_executor(name: str, **kw) -> ClientExecutor:
    try:
        factory = _EXECUTORS[name]
    except KeyError:
        raise KeyError(f"unknown executor {name!r}; "
                       f"registered: {available_executors()}") from None
    return factory(**kw)


def available_executors() -> List[str]:
    return sorted(_EXECUTORS)


register_executor("sequential", SequentialExecutor)
register_executor("vmapped", VmappedExecutor)
register_executor("async", AsyncDispatchExecutor)
