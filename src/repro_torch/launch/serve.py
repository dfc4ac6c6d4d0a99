"""Batched serving: prefill + decode loop with temperature sampling.

``--arch`` names any model of the zoo: yi-6b, gemma-7b, minitron-4b,
h2o-danube-3-4b, rwkv6-3b, hymba-1.5b, olmoe-1b-7b, phi3.5-moe,
whisper-medium, internvl2-76b.  Whisper and InternVL2 get random frontend
embeddings (the frontends are stubs, as in the reference).
CPU-feasible with reduced configs (``--device cpu``):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \\
        --device cpu --temperature 0

on the card at full width:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --full \\
        --batch 4 --prompt-len 1024 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b --full \\
        --batch 4 --prompt-len 2048 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3.5-moe --full \\
        --layers 4 --batch 4 --prompt-len 1024 --gen 32
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs import get_model_config
from repro_torch.data import make_lm_stream
from repro_torch.models import transformer as T


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample(logits: torch.Tensor, temperature: float,
           gen: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) logits -> (B,) int32 tokens: greedy at ``temperature`` 0, else
    a draw from softmax(logits / temperature) on ``gen``."""
    if temperature > 0:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def serve(arch: str = "yi-6b", smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen: int = 64, temperature: float = 0.8,
          seed: int = 0, verbose: bool = True,
          device: DeviceLike = None, layers: Optional[int] = None) -> Dict[str, float]:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens from the synthetic
    stream, then decode ``gen`` tokens each; returns the reference's stats.
    ``layers`` cuts the model's depth (the decoder's; whisper's encoder
    keeps its own), for a model whose full depth does not fit the device.

    A model with a frontend gets random embeddings in the config's dtype,
    as in the reference: (batch, n, embed_dim), n the image tokens of the
    VLM (which count toward the cache's length) or whisper's encoder frames.

    Prefill goes through the kernels (``impl="flash"``): flash attention,
    and for Hymba and RWKV6 the mamba selective scan and the rwkv6 WKV.
    That is the one departure from the reference's ``serve``, which
    prefills with ``T.prefill``'s default ``impl="naive"``, its oracle for
    smoke tests (its Pallas routes are the TPU's).  At full width a naive
    prefill builds the (S, S) score matrix of every head that the attention
    kernel exists to avoid; ``impl`` is an existing argument of
    ``T.prefill``.
    Decode goes through ``T._decode_step_into`` (``T.decode_step`` writing
    the caches in place: the old state is never reused); Hymba's and RWKV6's
    mixers launch their kernel once per layer and token.  Sampling draws
    from a ``torch.Generator`` on the device, another stream than
    ``jax.random.categorical``'s; ``temperature=0`` is greedy.
    """
    dev = resolve_device(device)
    cfg = get_model_config(arch, smoke=smoke)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = T.init_params(seed, cfg, dev)
    fe = None
    if cfg.frontend is not None:
        n = cfg.frontend.n_tokens if not cfg.enc_dec else cfg.enc_seq
        fe = torch.randn((batch, n, cfg.frontend.embed_dim),
                         generator=torch.Generator(device=dev).manual_seed(seed),
                         device=dev).to(T.torch_dtype(cfg.dtype))
    stream = make_lm_stream(n_tokens=prompt_len * batch + 16,
                            vocab=cfg.vocab_size, seed=seed)
    prompts = np.stack([stream[i * prompt_len:(i + 1) * prompt_len]
                        for i in range(batch)])
    max_len = prompt_len + gen + (cfg.frontend.n_tokens
                                  if cfg.frontend and not cfg.enc_dec else 0)
    sampler = torch.Generator(device=dev).manual_seed(seed)

    _sync(dev)
    t0 = time.perf_counter()
    logits, state = T.prefill(params, cfg, torch.as_tensor(prompts, device=dev), fe,
                              max_len=max_len, impl="flash", last_only=True)
    logits = logits[:, 0]
    _sync(dev)
    prefill_s = time.perf_counter() - t0

    toks = []
    t1 = time.perf_counter()
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for _ in range(gen):
        toks.append(tok)
        logits, state = T._decode_step_into(params, cfg, state, tok)
        tok = sample(logits, temperature, sampler)
    _sync(dev)
    decode_s = time.perf_counter() - t1
    out = torch.stack(toks, 1).cpu().numpy()

    stats = {
        "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_tok_per_s": batch * gen / max(decode_s, 1e-9),
        "prefill_tok_per_s": batch * prompt_len / max(prefill_s, 1e-9),
    }
    if verbose:
        print(f"arch={cfg.name} batch={batch} prompt={prompt_len} gen={gen} device={dev}")
        print(f"prefill: {stats['prefill_tok_per_s']:,.0f} tok/s  "
              f"decode: {stats['decode_tok_per_s']:,.0f} tok/s")
        print("sample:", out[0][:24].tolist())
    return stats


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b",
                    help="yi-6b, gemma-7b, minitron-4b, h2o-danube-3-4b, rwkv6-3b, "
                         "hymba-1.5b, olmoe-1b-7b, phi3.5-moe, whisper-medium or "
                         "internvl2-76b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many (decoder) layers")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless given (e.g. cpu)")
    args = ap.parse_args()
    serve(args.arch, smoke=args.smoke, batch=args.batch,
          prompt_len=args.prompt_len, gen=args.gen,
          temperature=args.temperature, device=args.device, layers=args.layers)


if __name__ == "__main__":
    main()
