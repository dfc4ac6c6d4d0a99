"""Serve a (reduced) architecture of the zoo on the PyTorch port: batched
prefill through the kernels, then the decode loop.

    PYTHONPATH=src python examples/torch/serve_lm.py --arch rwkv6-3b --gen 48
    PYTHONPATH=src python examples/torch/serve_lm.py --arch hymba-1.5b --device cpu
    PYTHONPATH=src python examples/torch/serve_lm.py --arch whisper-medium --device cpu

Every architecture of the zoo serves: the MoE models (olmoe-1b-7b,
phi3.5-moe), whisper-medium over random audio frames and internvl2-76b
after random image tokens too.
"""
from __future__ import annotations

import argparse

from repro_torch.launch.serve import serve


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--device", default="cuda", help="torch device (e.g. cpu)")
    args = ap.parse_args(argv)
    stats = serve(args.arch, smoke=True, batch=args.batch,
                  prompt_len=args.prompt_len, gen=args.gen, device=args.device)
    assert stats["decode_tok_per_s"] > 0


if __name__ == "__main__":
    main()
