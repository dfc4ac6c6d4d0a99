"""Profiling hooks: attributable op timings + an optional torch.profiler gate.

Kernel ops (:mod:`repro_torch.kernels.select_topk.ops`,
:mod:`repro_torch.kernels.fleet_state.ops`) and the executors can't see
which server (if any) is observing them, so op timing routes through a
module global: a server whose recorder is enabled registers it with
:func:`set_profiler`, and :func:`timed_call` becomes a timed call, fenced by
``torch.cuda.synchronize`` when its output holds a CUDA tensor, feeding
:meth:`~repro_torch.obs.recorder.RunRecorder.record_op`.  With no active
profiler (the default) ``timed_call`` is a plain passthrough — one ``is
None`` check per call, no timing, no device sync — so un-observed runs pay
nothing and queued device work keeps overlapping host work (the fence only
exists while someone is measuring).  :func:`span` takes the same route for
spans: code with no recorder in hand (the executor, the client loop, the
policy) opens a nested span of the active recorder, or the shared no-op span.

:func:`trace_gate` wraps a block in ``torch.profiler.profile`` and writes a
Chrome trace when a trace directory is supplied (argument or the
``REPRO_TORCH_TRACE`` env var), for kernel-level drill-down past the span
layer.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional

import torch

from repro_torch.obs.recorder import _NULL_SPAN

_ACTIVE = None


def set_profiler(recorder) -> None:
    """Make ``recorder`` the destination for :func:`timed_call` timings."""
    global _ACTIVE
    _ACTIVE = recorder


def clear_profiler(recorder=None) -> None:
    """Deactivate profiling (pass the recorder to clear only if it is
    still the active one — lets servers clean up without clobbering a
    newer registration)."""
    global _ACTIVE
    if recorder is None or _ACTIVE is recorder:
        _ACTIVE = None


def active_profiler():
    return _ACTIVE


def span(name: str):
    """A span of the active recorder, nested in whatever span is open there,
    or the shared no-op span when none is active."""
    prof = _ACTIVE
    if prof is None:
        return _NULL_SPAN
    return prof.span(name)


def _cuda_device(out) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``out`` (a tensor, or dicts,
    lists and tuples of them), else None."""
    if isinstance(out, torch.Tensor):
        return out.device if out.is_cuda else None
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            dev = _cuda_device(v)
            if dev is not None:
                return dev
    return None


def fence(out):
    """Wait for the card's queued work when ``out`` holds a CUDA tensor (the
    counterpart of ``jax.block_until_ready``); returns ``out``."""
    dev = _cuda_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
    return out


def timed_call(name: str, fn, *args, **kwargs):
    """Call ``fn(*args, **kwargs)``; when a profiler is active, fence the
    result with ``torch.cuda.synchronize`` if it holds a CUDA tensor (so
    device work is charged to the op that launched it, not the next host
    sync) and record the wall-clock under ``name``."""
    prof = _ACTIVE
    if prof is None:
        return fn(*args, **kwargs)
    t0 = time.perf_counter()
    out = fence(fn(*args, **kwargs))
    prof.record_op(name, time.perf_counter() - t0)
    return out


@contextmanager
def trace_gate(out_dir: Optional[str] = None):
    """Optionally wrap a block in ``torch.profiler.profile`` (CPU activity,
    and CUDA's when a card is present) and export a Chrome trace into the
    directory.  Active when ``out_dir`` is given or ``REPRO_TORCH_TRACE``
    names a directory; yields the trace file's path, or None (a no-op)
    otherwise."""
    target = out_dir or os.environ.get("REPRO_TORCH_TRACE")
    if not target:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(target, exist_ok=True)
    path = os.path.join(target, f"trace_{os.getpid()}_{time.time_ns()}.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
