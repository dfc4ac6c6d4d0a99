"""End-to-end LM training driver.

Runs real training steps: on the CPU at the reduced (``--smoke``)
configs, on the card at any size that fits it.  Used by
``examples/torch/train_lm.py`` and the tests.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 200 --batch 8 --seq 128 [--device cpu]

Weights come from the port's ``init_params`` (a ``torch.Generator`` seeded
with ``seed``), other numbers than the reference's ``jax.random``; the
batches are the reference's numpy stream, draw for draw.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.checkpoint import save_pytree
from repro_torch.configs import get_model_config
from repro_torch.data import make_lm_stream
from repro_torch.fl._tree import tree_leaves
from repro_torch.launch.steps import make_train_step
from repro_torch.models import transformer as T
from repro_torch.optim import adamw, linear_warmup_cosine


def lm_batches(tokens: np.ndarray, batch: int, seq: int, seed: int = 0,
               device: DeviceLike = None) -> Iterator[Dict[str, torch.Tensor]]:
    """Random windows of ``tokens``: the reference's numpy draws, as int32
    tensors (B, seq) on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = len(tokens) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        x = np.stack([tokens[s:s + seq] for s in starts]).astype(np.int32)
        y = np.stack([tokens[s + 1:s + seq + 1] for s in starts]).astype(np.int32)
        yield {"tokens": torch.as_tensor(x, device=dev),
               "labels": torch.as_tensor(y, device=dev)}


def train(arch: str = "yi-6b", smoke: bool = True, steps: int = 200,
          batch: int = 8, seq: int = 128, lr: float = 3e-3,
          log_every: int = 20, ckpt: Optional[str] = None,
          seed: int = 0, verbose: bool = True,
          device: DeviceLike = None) -> Dict[str, list]:
    """AdamW (``linear_warmup_cosine``, weight decay 0.01, clip 1.0) on the
    synthetic LM stream, ``impl="naive"``, on ``device`` (the card unless
    ``device="cpu"``).  The loss is read (a host sync) only every
    ``log_every`` steps and at the last.  Returns the logged history."""
    cfg = get_model_config(arch, smoke=smoke)
    if cfg.frontend is not None:
        cfg = dataclasses.replace(cfg, frontend=None, enc_dec=False,
                                  n_enc_layers=0, enc_seq=0)
    dev = resolve_device(device)
    params = T.init_params(seed, cfg, dev)
    n_params = sum(p.numel() for p in tree_leaves(params))
    optimizer = adamw(linear_warmup_cosine(lr, steps // 10, steps),
                      weight_decay=0.01, grad_clip=1.0)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer, impl="naive")

    stream = make_lm_stream(n_tokens=1 << 17, vocab=cfg.vocab_size, seed=seed)
    batches = lm_batches(stream, batch, seq, seed, dev)
    hist = {"step": [], "loss": [], "tokens_per_s": []}
    t0 = time.time()
    tokens_done = 0
    for i in range(steps):
        b = next(batches)
        params, opt_state, metrics = step_fn(params, opt_state, b)
        tokens_done += batch * seq
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            tps = tokens_done / max(time.time() - t0, 1e-9)
            hist["step"].append(i)
            hist["loss"].append(loss)
            hist["tokens_per_s"].append(tps)
            if verbose:
                print(f"step {i:5d} loss {loss:.4f} ({tps:,.0f} tok/s, "
                      f"{n_params/1e6:.1f}M params)", flush=True)
    if ckpt:
        save_pytree({"params": params, "opt": opt_state}, ckpt)
        if verbose:
            print(f"checkpoint -> {ckpt}")
    return hist


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    hist = train(args.arch, smoke=args.smoke, steps=args.steps,
                 batch=args.batch, seq=args.seq, lr=args.lr, ckpt=args.ckpt,
                 device=args.device)
    first, last = hist["loss"][0], hist["loss"][-1]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
