"""End-to-end FedRank driver on the PyTorch port: imitation learning ->
online FL with every baseline, time/energy-to-accuracy report (the paper's
full pipeline, as ``examples/fl_end_to_end.py`` runs it on the JAX package).

A text-only architecture of the zoo can be the *global model* via --arch
(its reduced variant trains as a tiny LM across clients: yi-6b,
h2o-danube-3-4b, hymba-1.5b, rwkv6-3b, olmoe-1b-7b, phi3.5-moe, ...), or the
default MLP classification task (the paper's vision-task stand-in).

    PYTHONPATH=src python examples/torch/fl_end_to_end.py --rounds 25
    PYTHONPATH=src python examples/torch/fl_end_to_end.py --arch rwkv6-3b --rounds 8
    PYTHONPATH=src python examples/torch/fl_end_to_end.py --device cpu --rounds 2

whisper-medium and internvl2-76b are refused: their forward needs frontend
embeddings (audio frames, image tokens) that the synthetic LM data has
none of, as in the reference's example.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import get_model_config
from repro_torch.core import augment_demonstrations, collect_demonstrations, pretrain_qnet
from repro_torch.data import (
    FederatedData,
    SyntheticClassificationDataset,
    dirichlet_partition,
    make_classification_data,
    make_lm_stream,
)
from repro_torch.fl import (
    FLConfig,
    FLServer,
    LMTask,
    MLPTask,
    available_executors,
    available_scenarios,
    build_policy,
)

POLICY_NAMES = ("fedavg", "afl", "tifl", "oort", "favor", "fedmarl", "fedrank")
# sizes of the run (the reference example's)
N_SAMPLES = 12_000
LM_TOKENS = 120_000
ROUNDS_PER_EXPERT = 8
N_SYNTHETIC = 150
IL_STEPS = 800


def build_lm_fl_data(cfg, n_clients: int, seq: int = 32, seed: int = 0):
    """Synthetic LM federated data: sequences as 'samples', token-histogram
    Dirichlet partition for heterogeneity."""
    stream = make_lm_stream(n_tokens=LM_TOKENS, vocab=cfg.vocab_size, seed=seed)
    n_seq = len(stream) // (seq + 1)
    x = np.stack([stream[i * (seq + 1):(i + 1) * (seq + 1) - 1] for i in range(n_seq)])
    y = np.stack([stream[i * (seq + 1) + 1:(i + 1) * (seq + 1)] for i in range(n_seq)])
    # heterogeneity: partition by dominant leading token bucket
    labels = (x[:, 0] % 10).astype(np.int64)
    parts = dirichlet_partition(labels, n_clients, 0.3, seed=seed)
    train = SyntheticClassificationDataset(x, y, 10)      # LM pairs: tokens, next tokens
    test = SyntheticClassificationDataset(x[:200], y[:200], 10)
    return FederatedData(train, test, parts)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=25)
    ap.add_argument("--devices", type=int, default=40)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--sigma", type=float, default=0.1)
    ap.add_argument("--arch", default=None,
                    help="use a reduced architecture of the zoo as the FL global model")
    ap.add_argument("--executor", default="sequential",
                    choices=available_executors(),
                    help="client executor: 'vmapped' runs each cohort bucket as "
                         "one batched step")
    ap.add_argument("--scenario", default="uniform",
                    choices=available_scenarios(),
                    help="fleet environment: tier mix, load dynamics, "
                         "availability and failures (repro_torch.fl.scenarios)")
    ap.add_argument("--mode", default="sync", choices=("sync", "async"),
                    help="round regime: synchronous barrier rounds, or "
                         "asynchronous buffered aggregation (3x-K "
                         "concurrency, polynomial staleness weighting; "
                         "repro_torch.fl.async_engine)")
    ap.add_argument("--device", default="cuda", help="torch device (e.g. cpu)")
    args = ap.parse_args(argv)
    dev = args.device

    if args.arch:
        cfg = get_model_config(args.arch, smoke=True)
        if cfg.frontend is not None:
            raise SystemExit(
                f"fl_end_to_end: --arch {args.arch} is refused: its forward needs "
                f"frontend embeddings ({cfg.frontend.kind} frontend), and the "
                "synthetic LM data holds text tokens only")
        task = LMTask(cfg, seq_len=32)
        data = build_lm_fl_data(cfg, args.devices)
        lr = 0.5
    else:
        train, test = make_classification_data(n_samples=N_SAMPLES, seed=0)
        parts = dirichlet_partition(train.y, args.devices, args.sigma, seed=0)
        data = FederatedData(train, test, parts)
        task = MLPTask(dim=32, hidden=64, n_classes=10)
        lr = 0.1

    async_kw = ({"mode": "async", "async_concurrency": 3 * args.k,
                 "staleness": "polynomial"} if args.mode == "async" else {})

    def make_server(seed=1, **overrides):
        kw = {**async_kw, **overrides}
        return FLServer(FLConfig(n_devices=args.devices, k_select=args.k,
                                 rounds=args.rounds, l_ep=3, lr=lr, seed=seed,
                                 executor=args.executor,
                                 scenario=args.scenario, **kw),
                        task, data, device=dev)

    print("== collecting expert demonstrations (Alg. 1) ==")
    # IL demonstrations are always collected synchronously (the experts'
    # teacher signal is a full-round cohort); only online FL honors --mode
    demos = collect_demonstrations(lambda seed=1: make_server(seed, mode="sync"),
                                   rounds_per_expert=ROUNDS_PER_EXPERT)
    demos = augment_demonstrations(demos, n_synthetic=N_SYNTHETIC)
    qnet, il = pretrain_qnet(demos, steps=IL_STEPS, device=dev)
    print(f"IL: {len(demos)} demos, ranking acc {il['rank_acc'][-1]:.3f}, "
          f"top-10 overlap {il['top10_overlap'][-1]:.3f}")

    print("\n== online FL: all selection policies ==")
    results = {}
    for name in POLICY_NAMES:
        kw = ({"qnet": qnet, "k": args.k, "device": dev} if name == "fedrank"
              else {"device": dev} if name == "favor" else {})
        pol = build_policy(name, **kw)
        hist = make_server().run(pol)
        results[pol.name] = hist
        print(f"{pol.name:10s} acc={hist[-1].acc:.4f} "
              f"T={hist[-1].cum_time:8.1f}s E={hist[-1].cum_energy:9.1f}J")

    base = results["fedavg"]
    target = 0.95 * base[-1].acc
    print(f"\n== time/energy to {target:.3f} accuracy (95% of FedAvg final) ==")
    for name, hist in results.items():
        hit = next((r for r in hist if r.acc >= target), None)
        if hit:
            print(f"{name:10s} ToA={hit.cum_time:8.1f}s EoA={hit.cum_energy:9.1f}J "
                  f"(round {hit.round})")
        else:
            print(f"{name:10s} did not reach target")


if __name__ == "__main__":
    main()
