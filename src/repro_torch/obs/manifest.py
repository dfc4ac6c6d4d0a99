"""Run manifest: the reproducibility header written beside every run record.

One JSON document answering "what produced this record?": a canonical
sha256 digest of the :class:`~repro_torch.fl.server.FLConfig`, the scenario
and seed, the platform (python / OS / torch backend and the card's name),
and the package versions that shape numerics (torch, its CUDA, numpy).

Wall-clock-varying fields are confined to ``created_at`` so run records
stay comparable modulo the volatile keys.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import platform
from typing import Any, Optional

SCHEMA_VERSION = 1


def _jsonable(value: Any):
    """Best-effort canonical JSON form: dataclasses/arrays unfold, anything
    else falls back to ``repr`` (stable for the config objects we hash —
    attack models and topologies are dataclasses with deterministic reprs)."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {f.name: _jsonable(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if hasattr(value, "tolist"):          # numpy scalars and arrays
        return _jsonable(value.tolist())
    return repr(value)


def config_dict(cfg) -> dict:
    """The config as canonical JSON-native data.  ``observe`` is excluded:
    it names where the record goes, not what ran — two runs of the same
    experiment traced to different directories must share a digest."""
    d = _jsonable(cfg)
    if isinstance(d, dict):
        d.pop("observe", None)
    return d


def config_digest(cfg) -> str:
    """sha256 over the sorted-key JSON of :func:`config_dict` — the join
    key between run records and benchmark rows."""
    blob = json.dumps(config_dict(cfg), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def _versions() -> dict:
    import numpy
    import torch

    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "numpy": numpy.__version__}


def _device() -> Optional[str]:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else None


def run_manifest(cfg=None, scenario: Optional[str] = None,
                 extra: Optional[dict] = None) -> dict:
    """Build the manifest document.  ``cfg`` is an FLConfig (or any
    dataclass with ``scenario``/``seed`` fields); ``extra`` keys are merged
    at the top level (drivers add their sweep parameters)."""
    import time

    device = _device()
    doc = {
        "schema_version": SCHEMA_VERSION,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "platform": {
            "python": platform.python_version(),
            "system": platform.system(),
            "machine": platform.machine(),
            "backend": "cuda" if device is not None else "cpu",
            "device": device,
        },
        "versions": _versions(),
    }
    if cfg is not None:
        doc["config"] = config_dict(cfg)
        doc["config_digest"] = config_digest(cfg)
        doc["scenario"] = scenario or getattr(cfg, "scenario", None)
        doc["seed"] = getattr(cfg, "seed", None)
    elif scenario is not None:
        doc["scenario"] = scenario
    if extra:
        doc.update(extra)
    return doc
