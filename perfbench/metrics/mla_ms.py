"""``mla_ms``: the card's milliseconds a round in multi-head latent
attention (``models/attention.py`` ``mla_prefill``), the ``device_s`` of
every span whose leaf is ``mla``: each MLA block's forward inside the
vmapped gradient, remat's recompute of it in the backward, and the
evaluation's forwards.  A span's ``device_s`` is the stream's time from its
entry to its exit, so it includes the gaps in which the card waits for the
host to dispatch the block's operations.  Nothing to read without CUDA
events or without MLA."""
from __future__ import annotations

from perfbench.metrics._leaf_spans import leaf_ms


def read(rec):
    return leaf_ms(rec, ("mla",), "device_s")
