"""Per-layer metric readers, one module per metric, found by its name.

Each module defines ``read(rec) -> float | None``.  ``rec`` is the traced
run's record: ``rounds`` (the port's obs round records of the window: spans
with their wall seconds, fenced op timings), ``profile`` (the profiled
sub-window: ``busy_s``, ``window_s``, ``rounds``, ``device_ops`` and
``device_op_counts`` by kernel name), ``window_s`` (the traced window),
``round_flops`` (each window round's model FLOPs), ``config``, ``mix`` and
``peaks``.  A reader that finds nothing to read returns None and the metric
is left out of the line.
"""
