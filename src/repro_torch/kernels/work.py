"""The work of each model kernel, counted from its shapes: one formula per
kernel, used by the dry-run's cost counter
(:mod:`repro_torch.launch.hlo_cost`) and by ``chip_smoke.py``'s bound
column alike.

* ``flash_attention``: the two products (q.k and p.v), 2 Dh multiply-adds
  each, over the (query, key) pairs the causal and window masks allow, for
  every query head (the G heads of a KV group each count): tensor-core work,
  booked as ``dot_flops``;
* ``selective_scan``: per (sequence, token, channel, state entry) the
  decay's exp and product, the input term's products and the recurrence's
  multiply-add, the output's multiply-add (7 operations, the exp counted as
  one), plus ``dt * x`` once per channel; the exps also on their own;
* ``wkv6``: per (sequence, token, head) ``r.S``, ``w S + k v`` and the bonus
  term over the (n, n) state (5 n^2), plus 4 n for the bonus weights and the
  decay's exp; the exps also on their own;
* ``sgd_update``: the product and the difference, 2 operations per updated
  element.

The scans and the update run on the CUDA cores: the counter books their
operations as ``flops`` only.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple


def flash_pairs(s: int, causal: bool, window: Optional[int]) -> int:
    """The (query, key) pairs the mask allows in one head of one sequence of
    ``s`` positions: key j is seen by query i when j <= i (causal) and
    j > i - window (a window)."""
    if not window or window >= s:
        return s * (s + 1) // 2 if causal else s * s
    w = window
    if causal:
        return w * (w + 1) // 2 + (s - w) * w
    return s * s - (s - w) * (s - w + 1) // 2


def flash_flops(b: int, s: int, h: int, dh: int, causal: bool,
                window: Optional[int]) -> float:
    """4 Dh operations per allowed pair and query head."""
    return 4.0 * dh * flash_pairs(s, causal, window) * b * h


def scan_ops(b: int, t: int, inner: int, state: int) -> float:
    return float(b) * t * inner * (7 * state + 1)


def scan_exps(b: int, t: int, inner: int, state: int) -> float:
    return float(b) * t * inner * state


def wkv_ops(b: int, t: int, h: int, n: int) -> float:
    return float(b) * t * h * (5 * n * n + 4 * n)


def wkv_exps(b: int, t: int, h: int, n: int) -> float:
    return float(b) * t * h * n


def op_work(name: str, args: Sequence) -> Tuple[float, float]:
    """(flops, dot_flops) of one call of the ``repro_torch`` op ``name`` on
    ``args`` (its schema's positional arguments)."""
    if name == "flash_attention":
        q, causal, window = args[0], args[3], args[4]
        b, s, h, dh = q.shape
        f = flash_flops(b, s, h, dh, causal, window)
        return f, f
    if name == "selective_scan":
        b, t, inner = args[0].shape
        return scan_ops(b, t, inner, args[4].shape[-1]), 0.0
    if name == "wkv6":
        b, t, h, n = args[0].shape
        return wkv_ops(b, t, h, n), 0.0
    if name == "sgd_update":
        return 2.0 * args[0].numel(), 0.0
    raise KeyError(f"no work formula for repro_torch::{name}")
