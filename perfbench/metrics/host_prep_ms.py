"""``host_prep_ms``: the host's milliseconds a round in the work that feeds
the card: the fleet's round context (``fl/server.py``: ``advance_round`` and
``_ctx``, span ``context``), the clients' requests (``build_requests``, spans
``requests``) and the vmapped executor's inputs (``fl/engine.py``: padding,
permutations, stacking and uploads, spans ``inputs``), summed on the host's
clock."""
from __future__ import annotations

from perfbench.metrics._leaf_spans import leaf_ms


def read(rec):
    return leaf_ms(rec, ("context", "requests", "inputs"), "wall_s")
