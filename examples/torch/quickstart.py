"""Quickstart on the PyTorch port: FedRank client selection in ~50 lines.

    PYTHONPATH=src python examples/torch/quickstart.py            # on the card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

The same pipeline as ``examples/quickstart.py``, through ``repro_torch``:
policies are built by name from the registry (``build_policy``), the fleet
by name from the scenario registry (``FLConfig.scenario``), the round engine
by ``FLConfig.executor`` ("sequential" trains client by client, "vmapped"
each cohort bucket as one batched step) and the regime by ``FLConfig.mode``
("sync" barrier rounds, or "async" buffered staleness-weighted aggregation).
Every model, Q-net and training step lives on ``--device``.
"""
from __future__ import annotations

import argparse

from repro_torch.core import augment_demonstrations, collect_demonstrations, pretrain_qnet
from repro_torch.data import FederatedData, dirichlet_partition, make_classification_data
from repro_torch.fl import FLConfig, FLServer, MLPTask, build_policy

# sizes of the run (the reference example's)
N_SAMPLES = 8000
N_DEVICES = 30
K = 5
ROUNDS = 15
ROUNDS_PER_EXPERT = 6
N_SYNTHETIC = 100
IL_STEPS = 600


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="torch device (e.g. cpu)")
    args = ap.parse_args(argv)
    dev = args.device

    # 1. a federated dataset: Dirichlet(0.1) non-IID labels over the clients
    train, test = make_classification_data(n_samples=N_SAMPLES, seed=0)
    data = FederatedData(train, test, dirichlet_partition(train.y, N_DEVICES, 0.1, seed=0))
    task = MLPTask(dim=32, hidden=64, n_classes=10)

    def make_server(seed=1, **kw):
        return FLServer(
            FLConfig(n_devices=N_DEVICES, k_select=K, rounds=ROUNDS, l_ep=3, lr=0.1,
                     seed=seed,
                     scenario="cellular-tail",  # low-end-heavy fleet, dropout + deadline
                     executor="vmapped", **kw),  # cohort-batched; "sequential" = reference
            task, data, device=dev)

    # 2. imitation-learning pre-training against the analytical experts
    demos = collect_demonstrations(make_server, rounds_per_expert=ROUNDS_PER_EXPERT)
    qnet, il_hist = pretrain_qnet(augment_demonstrations(demos, N_SYNTHETIC),
                                  steps=IL_STEPS, device=dev)
    print(f"IL pretrain: pairwise ranking accuracy -> {il_hist['rank_acc'][-1]:.3f}")

    # 3. FL with FedRank vs random selection (policies built by name)
    for policy in (build_policy("fedavg"),
                   build_policy("fedrank", qnet=qnet, k=K, device=dev)):
        hist = make_server().run(policy)
        print(f"{policy.name:8s} acc {hist[0].acc:.3f} -> {hist[-1].acc:.3f}   "
              f"time {hist[-1].cum_time:7.1f}s   energy {hist[-1].cum_energy:7.1f}J")

    # 4. the same fleet, asynchronous regime: dispatch on arrival, aggregate
    #    every buffer_size uploads with polynomial staleness weighting;
    #    cum_time is the virtual clock over overlapping client work
    srv = make_server(mode="async", async_concurrency=3 * K, staleness="polynomial")
    hist = srv.run(build_policy("fedrank", qnet=qnet, k=K, device=dev))
    print(f"fedrank (async) acc {hist[0].acc:.3f} -> {hist[-1].acc:.3f}   "
          f"time {hist[-1].cum_time:7.1f}s   energy {hist[-1].cum_energy:7.1f}J")


if __name__ == "__main__":
    main()
