"""``executor_ms``: device-fenced milliseconds a round in the client
executor (``fl/engine.py`` ``VmappedExecutor`` through ``fl/client.py`` into
the model), from the op record ``executor.<name>`` that the server writes
under ``FLConfig.observe`` after a ``synchronize``."""
from __future__ import annotations


def read(rec):
    per = [sum(v["wall_s"] for k, v in r.get("ops", {}).items() if k.startswith("executor."))
           for r in rec.get("rounds") or []]
    return 1e3 * sum(per) / len(per) if per and any(per) else None
