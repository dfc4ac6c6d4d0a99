"""Train a (reduced) architecture of the zoo end to end on synthetic data
with the PyTorch port.

Default: reduced yi-6b for 200 steps on the card; any --arch the port runs
works, and ``--device cpu`` trains on the CPU.

    PYTHONPATH=src python examples/torch/train_lm.py --arch rwkv6-3b --steps 120
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu --steps 60
"""
from __future__ import annotations

import argparse

from repro_torch.launch.train import train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (e.g. cpu)")
    args = ap.parse_args(argv)
    hist = train(args.arch, smoke=True, steps=args.steps, batch=args.batch,
                 seq=args.seq, ckpt=args.ckpt, device=args.device)
    assert hist["loss"][-1] < hist["loss"][0], "training did not reduce loss"
    print(f"OK: loss {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}")


if __name__ == "__main__":
    main()
