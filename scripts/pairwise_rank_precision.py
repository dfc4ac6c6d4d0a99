#!/usr/bin/env python3
"""Hold one or more builds of ``pairwise_rank.cu`` to the fp64 plain version.

    python3 scripts/pairwise_rank_precision.py [LABEL=PATH ...]

Each argument names a ``pairwise_rank.cu`` source (default: the checkout's
``src/repro_torch/csrc/pairwise_rank.cu`` as ``current``).  Each is built
with the port's ``nvcc`` flags and driven through the port's wrappers on
the card, on the inputs ``chip_smoke.py`` gives ``pairwise_rank``: random
cohorts (70,000 of N=8 over five seeds, 16 of N in {30, 1000, 8192}), hard
and soft targets.  For every case it prints the gradient's largest error
as a share of its row's max |g_ref|, and the rows past ``chip_smoke.py``'s
tolerance (1e-5 of that max); the loss likewise.  Then it times the
gradient kernel (CUDA events, median of 25) at B=1, N=65,536 and at the IL
shape B=16, N=30.  Batches are launched in chunks of 65,535 rows, which a
source without its own chunking needs; every row's result is independent of
the chunking.  The last lines are the card's name and power limit, then
one JSON summary.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 65535


def run_source(torch, label, path):
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.pairwise_rank import kernel as pk

    lib = _build.CudaLibrary(f"pairwise_rank_{label}", pk._bind)
    lib.source = Path(path).resolve()
    saved, pk.LIBRARY = pk.LIBRARY, lib
    try:
        lib.build()

        def fwd_bwd(s, t, m, hard):
            losses, grads = [], []
            for r in range(0, s.shape[0], CHUNK):
                sl = slice(r, r + CHUNK)
                loss, count = pk.pairwise_rank_fwd_cuda(s[sl], t[sl], m[sl], hard=hard)
                g = torch.ones_like(loss)
                grads.append(pk.pairwise_rank_bwd_cuda(s[sl], t[sl], m[sl], count, g,
                                                       hard=hard))
                losses.append(loss)
            return torch.cat(losses), torch.cat(grads)

        cases = [dict(b=70_000, n=8, seed=36 + i) for i in range(5)]
        cases += [dict(b=16, n=n, seed=n) for n in (30, 1000, 8192)]
        rows = []
        for c in cases:
            for hard in (True, False):
                s, t, m = cs.pairwise_inputs(torch, c["b"], c["n"], seed=c["seed"])
                loss, grad = fwd_bwd(s, t, m, hard)
                ref_loss, ref_grad = cs.pairwise_plain(torch, s.double(), t.double(),
                                                       m.double(), hard)
                e_loss = (loss.double() - ref_loss).abs()
                tol_loss = cs.TOL * ref_loss.abs().clamp(min=1.0)
                g_max = ref_grad.abs().max(1).values
                e_grad = (grad.double() - ref_grad).abs().max(1).values
                share = torch.where(g_max > 0, e_grad / g_max.clamp(min=1e-300),
                                    torch.where(e_grad > 0, torch.inf, 0.0))
                worst = int(share.argmax())
                rows.append(dict(
                    source=label, b=c["b"], n=c["n"], seed=c["seed"],
                    targets="hard" if hard else "soft",
                    loss_rows_failing=int((e_loss > tol_loss).sum()),
                    grad_rows_failing=int((e_grad > cs.TOL * g_max).sum()),
                    grad_worst_share=float(share[worst]),
                    grad_worst_row=[float(e_grad[worst]), float(g_max[worst])]))
                cs.emit(phase="precision", **rows[-1])
        times = {}
        for shape, b, n in (("b1_n65536", 1, 65536), ("il_b16_n30", 16, 30)):
            s, t, m = cs.pairwise_inputs(torch, b, n, seed=b + n, masked_frac=0.0)
            _, count = pk.pairwise_rank_fwd_cuda(s, t, m, hard=True)
            g = torch.ones(b, device="cuda")
            times[shape] = cs.cuda_ms(torch, lambda: pk.pairwise_rank_bwd_cuda(
                s, t, m, count, g, hard=True))
            cs.emit(phase="timing", source=label, kernel="pairwise_rank_bwd",
                    shape=shape, ms=times[shape])
        return dict(cases=len(rows),
                    grad_rows_failing=sum(r["grad_rows_failing"] for r in rows),
                    loss_rows_failing=sum(r["loss_rows_failing"] for r in rows),
                    grad_worst_share=max(r["grad_worst_share"] for r in rows),
                    bwd_ms=times)
    finally:
        pk.LIBRARY = saved


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pairwise_rank_precision: this script needs a CUDA card")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs

    sources = dict(a.split("=", 1) for a in argv) or {
        "current": str(ROOT / "src/repro_torch/csrc/pairwise_rank.cu")}
    summary = {label: run_source(torch, label, path) for label, path in sources.items()}
    print(cs.card_line(), flush=True)
    print(json.dumps({"tolerance": "grad: 1e-5*max|g_ref| of its row; "
                                   "loss: 1e-5*max(1,|loss|)",
                      "sources": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
