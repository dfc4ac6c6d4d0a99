"""Structured logger: leveled key=value lines + recorder event feed.

The engines' round lines and stall diagnostics.  Each call names an
event and passes flat fields; the line renders as
``[repro_torch.fl] round policy=fedrank round=3 acc=0.41 ...`` when the level
clears the threshold, and the same event is forwarded to the run recorder
(when one is enabled) so console visibility and the JSONL record never
disagree.

Verbosity resolves ``FLConfig.log_level`` -> ``REPRO_LOG_LEVEL`` env ->
``"warning"`` (quiet by default: the historical ``verbose=True`` flag maps
to ``force=True``, printing regardless of level, which keeps
``run(verbose=True)`` behaviour).
"""
from __future__ import annotations

import os
import sys
from typing import Optional

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


def _fmt(value) -> str:
    if isinstance(value, float):
        return f"{value:.4g}"
    return str(value)


class StructuredLogger:
    def __init__(self, name: str = "repro_torch.fl", level: Optional[str] = None,
                 stream=None, recorder=None):
        level = (level or os.environ.get("REPRO_LOG_LEVEL") or "warning")
        if level not in LEVELS:
            raise ValueError(f"unknown log level {level!r}; expected one of "
                             f"{sorted(LEVELS)}")
        self.name = name
        self.level = LEVELS[level]
        self.stream = stream if stream is not None else sys.stdout
        self.recorder = recorder

    def log(self, event: str, level: str = "info", force: bool = False,
            **fields) -> None:
        """Emit one structured event.  ``force=True`` prints regardless of
        the threshold (the legacy ``verbose`` flag); the recorder (when
        enabled) gets the event either way."""
        if self.recorder is not None and self.recorder.enabled:
            self.recorder.event(event, level=level, **fields)
        if force or LEVELS[level] >= self.level:
            kv = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
            print(f"[{self.name}] {event} {kv}".rstrip(),
                  file=self.stream, flush=True)

    def debug(self, event: str, **fields) -> None:
        self.log(event, level="debug", **fields)

    def info(self, event: str, **fields) -> None:
        self.log(event, level="info", **fields)

    def warning(self, event: str, **fields) -> None:
        self.log(event, level="warning", **fields)

    def error(self, event: str, **fields) -> None:
        self.log(event, level="error", **fields)
