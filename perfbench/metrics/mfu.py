"""``mfu``: the whole round's share of the chip's dense bf16 peak: the
model FLOPs of the traced window's rounds (``perfbench/flops.py``) over the
window's seconds times 989 TFLOP/s."""
from __future__ import annotations


def read(rec):
    total = sum(rec.get("round_flops") or [])
    if total <= 0 or rec.get("window_s", 0) <= 0:
        return None
    return 100.0 * total / (rec["window_s"] * rec["peaks"]["bf16"])
