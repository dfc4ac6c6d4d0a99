"""``client_grad_ms``: the card's milliseconds a round in the vmapped
executor's gradient steps (``fl/client.py`` ``make_parallel_local_train``:
each ``torch.func.vmap(grad_and_value(...))`` call, i.e. the forward, remat's
recompute and the backward over the cohort), the ``device_s`` of every span
whose leaf is ``grad``.  Nothing to read without CUDA events."""
from __future__ import annotations

from perfbench.metrics._leaf_spans import leaf_ms


def read(rec):
    return leaf_ms(rec, ("grad",), "device_s")
