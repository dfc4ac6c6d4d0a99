"""``merge_eval_ms``: milliseconds a round from the merge to the end of the
evaluation (``fl/aggregation.py`` fedavg and ``FLServer._evaluate``): the
spans ``aggregate`` + ``telemetry`` + ``evaluate``, which follow each other.
The merge only enqueues its device work; the evaluation's host read waits
for it, so the sum is sound where ``aggregate`` alone is not."""
from __future__ import annotations

from perfbench.metrics._spans import mean_span_ms


def read(rec):
    return mean_span_ms(rec, ("aggregate", "telemetry", "evaluate"))
