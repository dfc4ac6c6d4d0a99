"""``merge_ms``: the card's milliseconds a round in the merge
(``fl/aggregation.py`` fedavg through ``robust_aggregate``), the ``device_s``
of the top-level span ``aggregate``: the merge's own device time, which
``merge_eval_ms`` bounds only from outside.  Nothing to read without CUDA
events."""
from __future__ import annotations

from perfbench.metrics._leaf_spans import path_ms


def read(rec):
    return path_ms(rec, "aggregate", "device_s")
