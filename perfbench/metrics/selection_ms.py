"""``selection_ms``: milliseconds a round in the FedRank selection layer
(``core/fedrank.py``: ``probe_set`` with its ``select_topk`` call, ``select``
and ``observe``'s TD steps), the spans ``plan`` + ``select`` + ``observe``.
Nothing to read where no ``select_topk`` op ran (a policy without FedRank's
cuts)."""
from __future__ import annotations

from perfbench.metrics._spans import mean_span_ms


def read(rec):
    rounds = rec.get("rounds") or []
    if not any(k.startswith("select_topk.") for r in rounds for k in r.get("ops", {})):
        return None
    return mean_span_ms(rec, ("plan", "select", "observe"))
