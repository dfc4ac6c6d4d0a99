"""``sgd_update_ms``: the card's milliseconds a round in the vmapped
executor's SGD updates (``fl/client.py``: ``tree_map(_sgd_stacked(lr), ...)``
over the stacked clients' parameters after each gradient step), the
``device_s`` of every span whose leaf is ``sgd_update``.  Nothing to read
without CUDA events."""
from __future__ import annotations

from perfbench.metrics._leaf_spans import leaf_ms


def read(rec):
    return leaf_ms(rec, ("sgd_update",), "device_s")
