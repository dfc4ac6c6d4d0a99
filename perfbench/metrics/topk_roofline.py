"""``topk_roofline``: the ``select_topk`` kernel's share of its roofline:
the least time of each call of the profiled rounds (``flops.topk_bound_ms``
at the call's N, F, H and K) over the device time of the
``select_topk_fused`` launches.  A FedRank round makes two calls: the
fleet's provisional cut (N devices, K scored probes) and the probed
cohort's full order.  Nothing to read where the trace holds no launch or
lost some."""
from __future__ import annotations

from perfbench import flops
from perfbench.reference.fl import DEFAULT_FEDRANK, probe_sizes
from perfbench.weights import QNET_HIDDEN, QNET_IN


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    names = [n for n in prof["device_ops"] if "select_topk_fused" in n]
    launches = sum(prof["device_op_counts"][n] for n in names)
    rounds = prof["rounds"]
    if not names or launches != 2 * rounds:
        return None
    mix = rec["mix"]
    pf = dict(DEFAULT_FEDRANK, **mix.get("policy_kwargs", {}))["probe_factor"]
    m, m_top = probe_sizes(mix["n_devices"], mix["k"], pf)
    bound_ms = rounds * (flops.topk_bound_ms(mix["n_devices"], QNET_IN, QNET_HIDDEN, m_top)
                         + flops.topk_bound_ms(m, QNET_IN, QNET_HIDDEN, m))
    device_ms = 1e3 * sum(prof["device_ops"][n] for n in names)
    return 100.0 * bound_ms / device_ms
