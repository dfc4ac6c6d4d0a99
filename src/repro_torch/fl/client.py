"""Client local training: SGD epochs, FedProx proximal term, probing epoch.

A client shard is padded to a power-of-two bucket with a validity mask (the
reference's single padding rule, kept here so both packages batch a shard the
same way), and each epoch walks a host permutation drawn from
``np.random.default_rng(seed)`` exactly as the reference does.  The gather by
that permutation and every SGD step run on the params' device.

:func:`make_parallel_local_train` is the cohort-batched path: K clients'
local training as one ``torch.func.vmap`` of ``grad_and_value`` over the
client axis, the shuffle orders fed in as gather indices, so it replays
:func:`local_train` client by client.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.fl._tree import tree_device, tree_iter, tree_leaves, tree_map, tree_unflatten
from repro_torch.kernels.sgd_update import sgd_update, sgd_update_cuda
from repro_torch.obs.profiling import active_profiler, span

Params = Dict[str, torch.Tensor]
ArrayLike = Union[np.ndarray, torch.Tensor]


def _bucket_cap(n: int) -> int:
    """Padded shard size: next power of two, minimum 8."""
    return max(8, 1 << (n - 1).bit_length())


def _bucket_geometry(n: int, batch_size: int) -> Tuple[int, int, int]:
    """(cap, batch_size, n_batches) for an n-sample client shard — the single
    source of the padding/batching rule; a diverging copy would silently
    break parity with the reference."""
    cap = _bucket_cap(n)
    bs = min(batch_size, cap)
    return cap, bs, cap // bs


def _pad_bucket(x: torch.Tensor, y: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Zero-pad (x, y) to the bucket cap; mask is 1 on real rows."""
    n = len(y)
    pad = _bucket_cap(n) - n
    xpad = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    ypad = torch.cat([y, y.new_zeros((pad,) + tuple(y.shape[1:]))])
    mask = torch.cat([torch.ones(n, dtype=torch.float32, device=x.device),
                      torch.zeros(pad, dtype=torch.float32, device=x.device)])
    return xpad, ypad, mask


def _prox_sq(p: Params, anchor: Params) -> torch.Tensor:
    """FedProx's squared distance to the anchor, summed in fp32 leaf by leaf
    in storage order."""
    return sum(tree_iter(tree_map(
        lambda a, b: torch.sum(torch.square(a.float() - b.float())), p, anchor)))


def _sgd_leaf(lr: float):
    """One SGD update of a leaf in fp32, cast back to the leaf's dtype."""
    return lambda a, g: (a.float() - lr * g.float()).to(a.dtype)


def _sgd_stacked(lr: float):
    """:func:`_sgd_leaf` over a leaf with a leading client axis, as the op
    ``repro_torch::sgd_update`` (:mod:`repro_torch.kernels.sgd_update`): on
    the card one kernel that reads the leaf and its gradient once, on the
    CPU the plain version.  Under an active recorder each leaf counts into
    the round record: ``sgd_update.launches``, and the elements updated by
    the kernel (``sgd_update.kernel_elements``) against all updated
    (``sgd_update.elements``)."""
    def one(a, g):
        prof = active_profiler()
        if prof is None:
            return sgd_update(a, g, lr)
        before = sgd_update_cuda.launches
        out = sgd_update(a, g, lr)
        launched = sgd_update_cuda.launches - before
        prof.metrics.count("sgd_update.launches", launched)
        prof.metrics.count("sgd_update.elements", out.numel())
        prof.metrics.count("sgd_update.kernel_elements", out.numel() if launched else 0)
        return out
    return one


def _sgd_epoch(task, params: Params, p_global: Params, x: torch.Tensor,
               y: torch.Tensor, mask: torch.Tensor, *, lr: float,
               batch_size: int, n_batches: int, prox_mu: float
               ) -> Tuple[Params, torch.Tensor]:
    """One local epoch = n_batches SGD steps over a params tree; returns
    (params, mean loss).  Each leaf steps in fp32 and keeps its dtype."""
    losses = []
    for b in range(n_batches):
        sl = slice(b * batch_size, (b + 1) * batch_size)
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss = task.loss(p, {"x": x[sl], "y": y[sl], "mask": mask[sl]})
        if prox_mu > 0.0:
            loss = loss + 0.5 * prox_mu * _prox_sq(p, p_global)
        grads = tree_unflatten(p, torch.autograd.grad(loss, tree_leaves(p)))
        with torch.no_grad():
            params = tree_map(_sgd_leaf(lr), p, grads)
        losses.append(loss.detach())
    return params, torch.stack(losses).mean()


def local_train(
    task,
    params: Params,
    x: ArrayLike,
    y: ArrayLike,
    *,
    epochs: int,
    lr: float,
    batch_size: int = 32,
    prox_mu: float = 0.0,
    seed: int = 0,
) -> Tuple[Params, np.ndarray]:
    """Run ``epochs`` local epochs on the params' device.  Returns (params,
    per-epoch mean losses); losses[0] is the probing loss FedRank reports."""
    device = tree_device(params)
    x = torch.as_tensor(x, device=device)
    y = torch.as_tensor(y, device=device)
    rng = np.random.default_rng(seed)
    xpad, ypad, mask = _pad_bucket(x, y)
    cap, bs, nb = _bucket_geometry(len(y), batch_size)
    p_global = params
    losses = []
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(cap)[: nb * bs], device=device)
        params, loss = _sgd_epoch(task, params, p_global, xpad[perm],
                                  ypad[perm], mask[perm], lr=lr,
                                  batch_size=bs, n_batches=nb,
                                  prox_mu=float(prox_mu))
        losses.append(loss)
    if not losses:
        return params, np.zeros(0)
    # one device->host copy for all epochs' losses
    return params, torch.stack(losses).double().cpu().numpy()


def probing_epoch(task, params: Params, x: ArrayLike, y: ArrayLike, *,
                  lr: float, batch_size: int = 32, prox_mu: float = 0.0,
                  seed: int = 0) -> Tuple[Params, float]:
    """The paper's "early exit" probe: exactly one local epoch; returns the
    partially-trained params (reused if the device is selected) + probe loss."""
    params, losses = local_train(task, params, x, y, epochs=1, lr=lr,
                                 batch_size=batch_size, prox_mu=prox_mu, seed=seed)
    return params, float(losses[0])


# ---------------------------------------------------------------------------
# Cohort-batched client training (vmapped over the client axis)
# ---------------------------------------------------------------------------


def make_parallel_local_train(task, *, batch_size: int, n_batches: int,
                              epochs: int, prox_mu: float = 0.0,
                              stacked_params: bool = False) -> Callable:
    """Returns f(init_params, xs (K, cap, ...), ys, masks, lr[, perms])
    -> (stacked client params (K, ...), per-epoch mean losses (K, epochs)).

    Each SGD step is one ``torch.func.vmap`` of ``grad_and_value`` of
    ``task.loss`` over the client axis; the epoch and batch loops are Python
    loops on the host.

    * ``stacked_params=True`` takes a leading client axis on every leaf of
      ``init_params`` (each client resumes from its own params, e.g. the
      probe stage's output); otherwise the one dict is broadcast (an
      ``expand``, no copy).  The FedProx term anchors to each client's own
      init, as :func:`local_train` does.
    * ``perms`` (K, epochs, n_batches*batch_size) integer gather indices
      give each client's per-epoch shuffle order, so the caller can replay
      :func:`local_train`'s host shuffles exactly; when omitted, every epoch
      walks the shards in storage order.
    * ``losses[:, 0]`` is the probe loss FedRank reports.
    """
    take = n_batches * batch_size

    def loss_fn(p, p_init, xb, yb, mb):
        loss = task.loss(p, {"x": xb, "y": yb, "mask": mb})
        if prox_mu > 0.0:
            loss = loss + 0.5 * prox_mu * _prox_sq(p, p_init)
        return loss

    step = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def parallel(p_init: Params, xs: torch.Tensor, ys: torch.Tensor,
                 masks: torch.Tensor, lr: float,
                 perms: Optional[torch.Tensor] = None
                 ) -> Tuple[Params, torch.Tensor]:
        k = xs.shape[0]
        if not stacked_params:
            p_init = tree_map(lambda a: a.unsqueeze(0).expand((k,) + tuple(a.shape)),
                              p_init)
        if perms is None:
            perms = torch.arange(take, device=xs.device).expand(k, epochs, take)
        params = p_init
        ep_losses = []
        for e in range(epochs):
            pe = perms[:, e].long()
            xe = torch.take_along_dim(
                xs, pe.view((k, take) + (1,) * (xs.dim() - 2)), dim=1)
            ye = torch.take_along_dim(ys, pe.view((k, take) + (1,) * (ys.dim() - 2)),
                                      dim=1)
            me = torch.take_along_dim(masks, pe, dim=1)
            losses = []
            for b in range(n_batches):
                sl = slice(b * batch_size, (b + 1) * batch_size)
                # host spans outside every transform: the vmapped forward,
                # recompute and backward, then the update
                with span("grad"):
                    grads, loss = step(params, p_init, xe[:, sl], ye[:, sl], me[:, sl])
                with span("sgd_update"):
                    params = tree_map(_sgd_stacked(lr), params, grads)
                losses.append(loss)
            ep_losses.append(torch.stack(losses, dim=1).mean(dim=1))
        if not ep_losses:
            return params, xs.new_zeros((k, 0), dtype=torch.float32)
        return params, torch.stack(ep_losses, dim=1)

    return parallel
