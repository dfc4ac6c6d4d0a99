"""Shared arithmetic of the span readers."""
from __future__ import annotations

from typing import Iterable, Optional


def mean_span_ms(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Mean per round of the summed wall time of top-level spans ``names``."""
    names = set(names)
    rounds = rec.get("rounds") or []
    per = [sum(s["wall_s"] for s in r.get("spans", []) if s["span"] in names)
           for r in rounds]
    return 1e3 * sum(per) / len(per) if per else None
