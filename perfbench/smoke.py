"""A cell at a size the CPU tests can hold: every width cut, the cell's
federation shape kept (its policy, cohort, rounds and batch), 40 devices
and sequences of 16 tokens.  For tests only; a run never uses it."""
from __future__ import annotations

from perfbench import bench


def smoke_spec(cell: str, dtype: str = "float32"):
    """(workload, configuration, mix) of ``cell`` at the smoke size."""
    wl, conf, mix = bench.load_cell(cell)
    conf = dict(conf, d_model=32, n_heads=4, head_dim=8, d_ff=64, vocab_size=128,
                dtype=dtype, n_kv_heads=2 if conf["n_kv_heads"] < conf["n_heads"] else 4)
    if "moe" in conf:
        conf["moe"] = dict(conf["moe"], n_experts=8, top_k=2, d_ff_expert=64)
    return wl, conf, dict(mix, n_devices=40, seq_len=16)
