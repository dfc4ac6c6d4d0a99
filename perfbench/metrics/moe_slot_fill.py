"""``moe_slot_fill``: percent of the expert buffers' rows that carry a
token, over the window's rounds: 100 x ``moe.pairs_kept`` / ``moe.slots``
from the round records' counters.  ``moe.slots`` counts the rows the
capacity-shaped expert products compute (held experts x capacity, a
layer and call), ``moe.pairs_kept`` the (token, choice) pairs routed to
the held experts that took one; the rest is padding those products
compute for nothing.  Counted by the expert layers that run outside every
``torch.func`` transform (the evaluation's forwards of the global model:
no number leaves the vmapped gradient).  Nothing to read where no round
counted a slot."""
from __future__ import annotations


def read(rec):
    slots = kept = 0
    for r in rec.get("rounds") or []:
        c = (r.get("metrics") or {}).get("counters") or {}
        slots += c.get("moe.slots", 0)
        kept += c.get("moe.pairs_kept", 0)
    return 100.0 * kept / slots if slots else None
