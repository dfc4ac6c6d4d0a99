"""Round-execution engine: RoundPlan + pluggable ClientExecutors.

* :class:`RoundPlan` — the stage structure of one FL round (probe → select
  → complete), emitted per policy by :func:`build_round_plan`.  Probing
  policies (FedRank) get a 1-epoch probe stage over ``policy.probe_set(ctx)``
  whose survivors complete the remaining ``l_ep - 1`` epochs; non-probing
  baselines get an empty probe stage and a full ``l_ep``-epoch completion.
* :class:`SequentialExecutor` — the reference semantics: one
  :func:`repro_torch.fl.client.local_train` call per client, in order.

* :class:`AsyncDispatchExecutor` — the ``"async"`` registry alias: it
  selects the asynchronous engine and delegates each wave's client work to
  its ``inner`` executor.

Executors are looked up by name (``FLConfig.executor``).  This package has
``"sequential"`` and ``"async"``; the cohort-batched ``"vmapped"`` executor
comes in a later slice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Protocol, Sequence

import numpy as np

from repro_torch.fl.client import local_train

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
    wave's client work goes to ``inner`` (default and only choice here:
    :class:`SequentialExecutor`).
    """

    name = "async"

    def __init__(self, inner=None, **kw):
        if isinstance(inner, str) and inner != "sequential":
            raise NotImplementedError(
                f"AsyncDispatchExecutor(inner={inner!r}) is not ported yet: "
                "the vmapped executor comes in a later slice of the port; "
                "this package has inner='sequential'")
        self.inner = (make_executor("sequential", **kw)
                      if inner is None or isinstance(inner, str) else inner)

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
register_executor("async", AsyncDispatchExecutor)
