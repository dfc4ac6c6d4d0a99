"""Shared arithmetic of the readers of the program's leaf spans: spans
matched by the last part of their path, at any depth, or by their whole
path, and read on the host's clock (``wall_s``) or the card's
(``device_s``, which a span carries only where CUDA ran)."""
from __future__ import annotations

from typing import Callable, Iterable, Optional


def _rounds(rec: dict):
    return [r for r in rec.get("rounds") or [] if r.get("type", "round") == "round"]


def _mean_ms(rec: dict, match: Callable[[str], bool], clock: str) -> Optional[float]:
    """Mean per round of the summed ``clock`` seconds of the spans whose
    path ``match`` accepts, in ms; None where no such span has the clock."""
    rounds, seen = _rounds(rec), False
    per = []
    for r in rounds:
        hits = [s[clock] for s in r.get("spans", []) if match(s["span"]) and clock in s]
        seen = seen or bool(hits)
        per.append(sum(hits))
    return 1e3 * sum(per) / len(per) if seen else None


def leaf_ms(rec: dict, leaves: Iterable[str], clock: str) -> Optional[float]:
    """Spans whose leaf name is one of ``leaves``, at any depth."""
    leaves = set(leaves)
    return _mean_ms(rec, lambda p: p.rsplit("/", 1)[-1] in leaves, clock)


def path_ms(rec: dict, path: str, clock: str) -> Optional[float]:
    """Spans at exactly ``path``."""
    return _mean_ms(rec, lambda p: p == path, clock)
