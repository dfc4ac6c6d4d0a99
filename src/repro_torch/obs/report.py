"""Run-record reduction: JSONL -> per-phase breakdown table.

The port's own copy of the reference's reduction (the port imports nothing
of the JAX package), so a run on the card is checked and tabled without
it.  A *run* is either a
directory holding ``manifest.json`` + ``run.jsonl`` or a bare ``.jsonl``
path; :func:`load_run` splits it into round records and events,
:func:`phase_table` folds every span into per-path totals (count, host
wall, share of measured round wall, virtual seconds), and
:func:`check_run` is the CI validity gate: schema keys present on every
round record and top-level span wall summing (within tolerance) to the
measured per-round ``host_time_s``.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

ROUND_KEYS = ("round", "mode", "host_time_s", "spans", "ops", "metrics")


def load_run(path: str) -> Tuple[Optional[dict], List[dict], List[dict]]:
    """Returns ``(manifest, rounds, events)`` for a run directory or a
    ``.jsonl`` file (manifest None in the latter case)."""
    manifest = None
    if os.path.isdir(path):
        mpath = os.path.join(path, "manifest.json")
        if os.path.exists(mpath):
            with open(mpath) as fh:
                manifest = json.load(fh)
        path = os.path.join(path, "run.jsonl")
    rounds, events = [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            (rounds if rec.get("type") == "round" else events).append(rec)
    return manifest, rounds, events


def phase_table(rounds: List[dict]) -> List[dict]:
    """Fold spans across rounds into one row per span path, sorted by
    total host wall descending.  ``share`` is the fraction of the summed
    per-round ``host_time_s`` (top-level phases should roughly partition
    it; nested paths overlap their parents by construction)."""
    total_host = sum(float(r.get("host_time_s", 0.0)) for r in rounds)
    acc: Dict[str, List[float]] = {}
    for rec in rounds:
        for sp in rec.get("spans", ()):
            row = acc.setdefault(sp["span"], [0, 0.0, 0.0])
            row[0] += 1
            row[1] += float(sp["wall_s"])
            if "v1_s" in sp:
                row[2] += float(sp["v1_s"]) - float(sp["v0_s"])
    table = [{"phase": path, "count": int(n), "wall_s": wall,
              "virtual_s": virt,
              "share": (wall / total_host if total_host > 0 else 0.0)}
             for path, (n, wall, virt) in acc.items()]
    table.sort(key=lambda row: -row["wall_s"])
    return table


def op_table(rounds: List[dict]) -> List[dict]:
    acc: Dict[str, List[float]] = {}
    for rec in rounds:
        for name, agg in rec.get("ops", {}).items():
            row = acc.setdefault(name, [0, 0.0])
            row[0] += int(agg["n"])
            row[1] += float(agg["wall_s"])
    table = [{"op": name, "n": int(n), "wall_s": wall}
             for name, (n, wall) in acc.items()]
    table.sort(key=lambda row: -row["wall_s"])
    return table


def coverage(rounds: List[dict]) -> float:
    """Summed top-level span wall over summed measured round wall.  Spans
    are sequential and non-overlapping at the top level, so this is <= ~1
    with the remainder being un-instrumented glue."""
    total_host = sum(float(r.get("host_time_s", 0.0)) for r in rounds)
    if total_host <= 0:
        return 0.0
    top = sum(float(sp["wall_s"]) for r in rounds for sp in r.get("spans", ())
              if "/" not in sp["span"])
    return top / total_host


def check_run(rounds: List[dict], min_coverage: float = 0.5,
              max_coverage: float = 1.1) -> List[str]:
    """Validity gate: returns a list of problems (empty = pass)."""
    problems = []
    if not rounds:
        problems.append("no round records")
        return problems
    for i, rec in enumerate(rounds):
        missing = [k for k in ROUND_KEYS if k not in rec]
        if missing:
            problems.append(f"round record {i} missing keys {missing}")
    cov = coverage(rounds)
    if not (min_coverage <= cov <= max_coverage):
        problems.append(
            f"span coverage {cov:.3f} outside [{min_coverage}, "
            f"{max_coverage}]: top-level spans do not account for the "
            "measured round wall-time")
    return problems


def render(manifest: Optional[dict], rounds: List[dict],
           events: List[dict]) -> str:
    """The human-readable breakdown: header, phase table, op table."""
    lines = []
    if manifest:
        lines.append(f"run: scenario={manifest.get('scenario')} "
                     f"seed={manifest.get('seed')} "
                     f"config={str(manifest.get('config_digest'))[:12]} "
                     f"backend={manifest.get('platform', {}).get('backend')}")
    total_host = sum(float(r.get("host_time_s", 0.0)) for r in rounds)
    lines.append(f"{len(rounds)} rounds, {len(events)} events, "
                 f"{total_host:.3f}s measured wall, "
                 f"coverage={coverage(rounds):.1%}")
    lines.append("")
    lines.append(f"{'phase':<28} {'count':>6} {'wall_s':>10} "
                 f"{'share':>7} {'virtual_s':>12}")
    for row in phase_table(rounds):
        lines.append(f"{row['phase']:<28} {row['count']:>6} "
                     f"{row['wall_s']:>10.4f} {row['share']:>6.1%} "
                     f"{row['virtual_s']:>12.1f}")
    ops = op_table(rounds)
    if ops:
        lines.append("")
        lines.append(f"{'op':<28} {'n':>6} {'wall_s':>10}")
        for row in ops:
            lines.append(f"{row['op']:<28} {row['n']:>6} "
                         f"{row['wall_s']:>10.4f}")
    return "\n".join(lines)
