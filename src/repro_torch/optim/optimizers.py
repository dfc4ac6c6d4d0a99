"""Functional optimizers over parameter trees (nested dicts of tensors).

An :class:`Optimizer` is a pair of pure functions ``(init, update)`` closed
over hyperparameters, as in the reference: ``update(grads, params, state)``
returns ``(new_params, new_state)`` and leaves its inputs as they were.
The state is a dict with the reference's keys (``{"mu", "nu", "step"}`` for
AdamW, ``{"step"[, "mom"]}`` for SGD), so checkpoints of either are read by
the other.  ``step`` is a 0-d int32 tensor on the params' device and the
schedules read it there, so an update never waits for the host.

Arithmetic follows the reference's order: each gradient is clipped in
fp32 and rounded back to its own dtype; the moments and the update are
fp32 (params may be bf16) and the new params are rounded back to each
leaf's dtype.  Leaves are visited in the reference's order (dict keys
sorted, recursively), which fixes the global norm's summation order.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.fl._tree import tree_leaves, tree_map, tree_unflatten

Params = Any
OptState = Dict[str, Any]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Params], OptState]
    update: Callable[[Params, Params, OptState], Tuple[Params, OptState]]
    # update(grads, params, state) -> (new_params, new_state)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 squares, leaf by leaf in the
    reference's order."""
    total = sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree))
    return torch.sqrt(total)


def clip_by_global_norm(tree: Params, max_norm: float) -> Tuple[Params, torch.Tensor]:
    """(tree scaled by ``min(1, max_norm / max(norm, 1e-9))``, norm); each
    leaf scaled in fp32 and rounded back to its dtype."""
    norm = global_norm(tree)
    # max_norm as a tensor: ``float / tensor`` would multiply by a reciprocal
    scale = torch.clamp(norm.new_tensor(max_norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _as_schedule(lr: Union[float, Schedule]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def _zero_step(params: Params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


def _map_unzip(fn: Callable, n: int, tree: Params, *rest: Params) -> Tuple[Params, ...]:
    """``fn`` returns an n-tuple per leaf; the n trees of ``tree``'s
    structure that hold them."""
    outs = [fn(*ls) for ls in zip(tree_leaves(tree), *map(tree_leaves, rest))]
    return tuple(tree_unflatten(tree, [o[i] for o in outs]) for i in range(n))


def adamw(
    lr: Union[float, Schedule],
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = 1.0,
    master_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """AdamW with fp32 master moments (params may be bf16)."""
    sched = _as_schedule(lr)

    def init(params: Params) -> OptState:
        zeros = lambda p: torch.zeros(p.shape, dtype=master_dtype, device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": _zero_step(params)}

    def update(grads: Params, params: Params, state: OptState):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        step = state["step"] + 1
        lr_t = sched(step)
        bc1 = 1.0 - b1 ** step.float()
        bc2 = 1.0 - b2 ** step.float()

        def upd(p, g, mu, nu):
            # the reference's expressions, written into fresh temporaries
            g = g.to(master_dtype)
            mu2 = b1 * mu
            mu2 += (1 - b1) * g
            nu2 = b2 * nu
            nu2 += (1 - b2) * torch.square(g)
            delta = (mu2 / bc1) / (torch.sqrt(nu2 / bc2) + eps)
            pm = p.to(master_dtype)
            if weight_decay:
                delta += weight_decay * pm
            return (pm - lr_t * delta).to(p.dtype), mu2, nu2

        new_params, new_mu, new_nu = _map_unzip(upd, 3, params, grads, state["mu"],
                                                 state["nu"])
        return new_params, {"mu": new_mu, "nu": new_nu, "step": step}

    return Optimizer(init, update)


def sgd(
    lr: Union[float, Schedule],
    *,
    momentum: float = 0.0,
    nesterov: bool = False,
    grad_clip: Optional[float] = None,
) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params: Params) -> OptState:
        st: OptState = {"step": _zero_step(params)}
        if momentum:
            st["mom"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                       device=p.device), params)
        return st

    def update(grads: Params, params: Params, state: OptState):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        step = state["step"] + 1
        lr_t = sched(step)
        if momentum:
            def upd(p, g, m):
                g = g.float()
                m2 = momentum * m + g
                d = g + momentum * m2 if nesterov else m2
                return (p.float() - lr_t * d).to(p.dtype), m2

            new_params, new_mom = _map_unzip(upd, 2, params, grads, state["mom"])
            return new_params, {"step": step, "mom": new_mom}
        new_params = tree_map(lambda p, g: (p.float() - lr_t * g.float()).to(p.dtype),
                              params, grads)
        return new_params, {"step": step}

    return Optimizer(init, update)
