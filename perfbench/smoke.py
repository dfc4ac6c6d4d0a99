"""A cell at a size the CPU tests can hold: every width cut by the cell's
family (``smoke`` in ``perfbench/families/<family>.py``), the cell's
federation shape kept (its policy, cohort, rounds and batch), 40 devices
and sequences of 16 tokens.  For tests only; a run never uses it."""
from __future__ import annotations

from perfbench import bench, families


def smoke_spec(cell: str, dtype: str = "float32"):
    """(workload, configuration, mix) of ``cell`` at the smoke size."""
    wl, conf, mix = bench.load_cell(cell)
    return wl, families.of(conf).smoke(conf, dtype), dict(mix, n_devices=40, seq_len=16)
