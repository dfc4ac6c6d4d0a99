"""Serve a stream of requests through the port's continuous-batching
scheduler.

    PYTHONPATH=src python examples/torch/continuous_batching.py --arch rwkv6-3b
    PYTHONPATH=src python examples/torch/continuous_batching.py --device cpu
    PYTHONPATH=src python examples/torch/continuous_batching.py --arch olmoe-1b-7b

Every architecture of the zoo runs; whisper-medium decodes against random
audio frames, one clip a slot (its encoder runs once, when the batcher is
made).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_model_config
from repro_torch.launch.scheduler import ContinuousBatcher, Request
from repro_torch.models import transformer as T


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--device", default="cuda", help="torch device (e.g. cpu)")
    args = ap.parse_args(argv)

    cfg = get_model_config(args.arch, smoke=True)
    params = T.init_params(0, cfg, args.device)
    frames = None
    if cfg.enc_dec:
        gen = torch.Generator(device=args.device).manual_seed(0)
        frames = torch.randn((args.slots, cfg.enc_seq, cfg.frontend.embed_dim),
                             generator=gen, device=args.device).to(T.torch_dtype(cfg.dtype))
    batcher = ContinuousBatcher(cfg, params, batch_slots=args.slots, max_len=128,
                                device=args.device, frontend_embeds=frames)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 16))
        batcher.submit(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, plen).astype(np.int32),
            max_new=args.max_new))
    stats = batcher.run()
    print(f"arch={cfg.name} slots={args.slots} requests={args.requests}")
    print(f"completed={stats.completed} decode_steps={stats.decode_steps} "
          f"tokens={stats.tokens_out}")
    print(f"throughput={stats.tok_per_s:,.1f} tok/s  "
          f"mean TTFT={stats.mean_ttft_s * 1e3:.0f} ms  "
          f"mean latency={stats.mean_latency_s * 1e3:.0f} ms")
    for r in batcher.completed[:3]:
        print(f"  req {r.rid}: {r.out[:10]}")


if __name__ == "__main__":
    main()
