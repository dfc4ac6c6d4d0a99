"""``moe_ms``: the card's milliseconds a round in the expert layers
(``models/moe.py`` ``apply_moe``: routing, dispatch, the experts' products,
the combine and any shared experts), the ``device_s`` of every span whose
leaf is ``moe``: each layer's forward inside the vmapped gradient, remat's
recompute of it, and the evaluation's forwards.  A span's ``device_s`` is
the stream's time from its entry to its exit, so it includes the gaps in
which the card waits for the host to dispatch the layer's operations.
Nothing to read without CUDA events or without expert layers."""
from __future__ import annotations

from perfbench.metrics._leaf_spans import leaf_ms


def read(rec):
    return leaf_ms(rec, ("moe",), "device_s")
