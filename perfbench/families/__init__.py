"""Model families, one module per family, found by its file.

A configuration file names its family under ``"family"``; a file without
the key is of the ``decoder`` family.  ``families/<name>.py`` defines:

* ``dims(raw) -> conf``: the file's published keys in the harness's names;
* ``port_fields(conf, base) -> dict``: the fields that replace those of the
  port's registry ``ModelConfig`` ``base``;
* ``weights(conf, gen, device) -> params``: the weights in the port's
  layout, drawn from the generator ``gen`` (``perfbench/weights.py`` holds
  the initialisers);
* ``forward(p, conf, tokens, prec) -> (logits fp32, aux loss)``: the plain
  reference (``perfbench/reference/model.py`` holds the shared pieces and
  :class:`~perfbench.reference.model.Precision`); it imports nothing of the
  port;
* ``matmul_params(conf)`` and ``attention_flops(conf, seq)``: the counts
  ``perfbench/flops.py`` makes a round's model FLOPs from;
* ``smoke(conf, dtype) -> conf``: the configuration at the CPU tests' size.

A family may also keep the roofline counts of its own kernels.
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from types import ModuleType

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = "decoder"


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"perfbench.families.{Path(path).stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load(name: str, root: Path = ROOT) -> ModuleType:
    """The family ``name``: ``<root>/families/<name>.py``."""
    return _load(str(Path(root).resolve() / "families" / f"{name}.py"))


def of(conf: dict) -> ModuleType:
    """The family of a configuration :func:`perfbench.bench.model_dims`
    made: the file under its ``family`` key, else ``decoder``."""
    return _load(conf["family"]) if "family" in conf else load(DEFAULT)
