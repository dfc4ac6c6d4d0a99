"""The comparison that decides ``correct``.

Both records come from :func:`perfbench.reference.fl.follow` (the
reference, and the fp8 control in the program's place) or from the
harness's log of the program's first rounds.  Each number is a gap between
the side judged and the reference; the workload file holds the limit of
each number the cell compares (a number with no limit there is worked out
and not compared).

* ``client_loss``: the largest relative gap of a trained client's epoch
  loss in the first round, over every client trained (every client starts
  from the benchmark's weights; in later rounds a client whose data an
  earlier merge has learned reads a loss near 3 in place of 12, and the
  relative gap of such a loss swings tenfold from seed to seed).
* ``test_loss``: the largest relative gap of the test loss after a round.
* ``update_first`` / ``update_last``: the global model's change after the
  first and after the last checked round (the server's first update as its
  merge gets it, and the update over all checked rounds), by the worst
  leaf: the gap between the two sides' L2 norms of that leaf's change, over
  the reference's norm of that leaf or of the median leaf, the larger.
  Leaves the reference moves by less than a thousandth of the median
  leaf's change are left out (round-off alone moves them).
* ``qnet``: the same for the Q-net's change after the last checked round.
* ``probe_cut`` / ``select_cut``: how far the side's two cohort cuts stray
  from the reference's scores (:func:`perfbench.reference.fl.cut_gap`),
  the largest over the rounds.
"""
from __future__ import annotations

import math
import sys
from typing import Dict

import numpy as np

from perfbench.reference.fl import DEFAULT_FEDRANK, cut_gap, probe_sizes


def _leaf_gap(side: Dict[str, float], ref: Dict[str, float]) -> float:
    med = float(np.median(list(ref.values())))
    worst = 0.0
    for name, r in ref.items():
        if r < 1e-3 * med:
            continue
        worst = max(worst, abs(side[name] - r) / max(r, med))
    return worst


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def compare(side: dict, ref: dict, mix: dict, n_online) -> Dict[str, float]:
    """The numbers compared, keyed by name (NaN or inf fail any limit)."""
    out = {"client_loss": 0.0, "test_loss": 0.0}
    fedrank = mix["policy"] == "fedrank"
    if fedrank:
        out.update(probe_cut=0.0, select_cut=0.0)
        pf = dict(DEFAULT_FEDRANK, **mix.get("policy_kwargs", {}))["probe_factor"]
    for r, (s, q) in enumerate(zip(side["rounds"], ref["rounds"])):
        for cid, loss in (q["client_loss"].items() if r == 0 else ()):
            out["client_loss"] = max(out["client_loss"], _rel(s["client_loss"][cid], loss))
        out["test_loss"] = max(out["test_loss"], _rel(s["test_loss"], q["test_loss"]))
        if fedrank:
            _, m_top = probe_sizes(int(n_online[r]), mix["k"], pf)
            top = np.asarray(s["probe_top"])
            out["probe_cut"] = max(out["probe_cut"],
                                   cut_gap(top, q["probe_top"], q["probe_scores"]))
            ids = np.asarray(sorted(q["select_scores"]))
            scores = np.asarray([q["select_scores"][i] for i in ids])
            pos = {int(c): j for j, c in enumerate(ids)}
            out["select_cut"] = max(out["select_cut"], cut_gap(
                np.asarray([pos[int(c)] for c in s["chosen"]]),
                np.asarray([pos[int(c)] for c in q["chosen"]]), scores))
    out["update_first"] = _leaf_gap(side["change_first"], ref["change_first"])
    out["update_last"] = _leaf_gap(side["change_last"], ref["change_last"])
    if fedrank:
        out["qnet"] = _leaf_gap(side["qnet_change"], ref["qnet_change"])
    return {k: float(v) for k, v in out.items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """True when every number the cell compares (those its workload file
    gives a limit) is finite and within its limit."""
    return bool(limits) and all(math.isfinite(numbers[k]) and numbers[k] <= lim
                                for k, lim in limits.items())


def table(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """Each number compared beside its limit: the result line's last key."""
    return {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}


def print_table(rows: dict) -> None:
    """The same, one line a number, on standard error."""
    for k, row in rows.items():
        print(f"check {k} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
