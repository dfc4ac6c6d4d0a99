"""``idle_share``: percent of the profiled rounds' wall time in which no
device operation ran (``torch.profiler``'s kernels, copies and fills,
merged)."""
from __future__ import annotations


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0 or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
