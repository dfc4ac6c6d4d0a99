#!/usr/bin/env python3
"""Hold one or more checkouts' ``pairwise_rank`` kernels to the fp64 plain
version, and time them, on one CUDA card.

    python3 scripts/pairwise_rank_precision.py [LABEL=ROOT ...]

Each argument names a checkout of this repository (default: this one, as
``current``); each is measured in a process of its own, with ``ROOT/src``
first on the path, in the order given (``parent=A current=. current2=.
parent2=A`` alternates two trees).  Each tree builds its own
``pairwise_rank.cu`` and is driven through its own wrappers, by the routes
it has:

* ``fused``: one launch for loss and gradient (fp32 pair terms in forms
  without cancellation, fp64 row sums), what a training step runs;
* ``loss_only``: the loss launch alone (under ``torch.no_grad``);
* ``two_calls``, in a tree from before the fused launch: the loss launch,
  then the gradient launch from its count (fp64 pair terms).

The inputs are ``chip_smoke.py``'s (this checkout's): random cohorts
(70,000 of N=8 over five seeds, 16 of N in {30, 1000, 8192}), hard and soft
targets, and well-ranked cohorts (hard targets, scores ordered as the
targets 4, 10 or 20 apart: losses down to ~1e-9).  For every case and route
it prints the rows past ``chip_smoke.py``'s tolerances: the gradient's
error over 1e-5 of its row's max |g_ref| (with the worst share), the loss's
over 1e-5 * max(1, |loss|), and on the well-ranked cohorts the loss's over
1e-5 * |loss|.  A route may keep fp32 terms only if it misses no row.  Then
it times each route (CUDA events, median of 25) at ``chip_smoke.py``'s four
shapes: the IL step B=16, N=30; B=1, N=8192; B=1, N=65,536; B=70,000, N=8.
Batches are launched in chunks of 65,535 rows, which a tree without its own
chunking needs; every row's result is independent of the chunking.

Prints one JSON line per tree, then the card's name and power limit.  Needs
a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 65535
SHAPES = (("il_b16_n30", 16, 30), ("b1_n8192", 1, 8192), ("b1_n65536", 1, 65536),
          ("b70000_n8", 70_000, 8))


def routes_of(torch, pk):
    """The tree's routes: name -> fn(s, t, m, hard) -> (loss, grad or None)."""
    def chunks(fn, s, t, m, hard):
        if s.shape[0] <= CHUNK:
            return fn(s, t, m, hard)
        outs = [fn(s[r:r + CHUNK], t[r:r + CHUNK], m[r:r + CHUNK], hard)
                for r in range(0, s.shape[0], CHUNK)]
        return tuple(None if o[0] is None else torch.cat(o) for o in zip(*outs))

    if hasattr(pk, "pairwise_rank_fused_cuda"):
        def fused(s, t, m, hard):
            loss, _, grad = pk.pairwise_rank_fused_cuda(s, t, m, hard=hard)
            return loss, grad

        def loss_only(s, t, m, hard):
            return pk.pairwise_rank_fwd_cuda(s, t, m, hard=hard)[0], None

        found = {"fused": fused, "loss_only": loss_only}
    else:                                  # a tree from before the fused launch
        def two_calls(s, t, m, hard):
            loss, count = pk.pairwise_rank_fwd_cuda(s, t, m, hard=hard)
            return loss, pk.pairwise_rank_bwd_cuda(s, t, m, count, torch.ones_like(loss),
                                                   hard=hard)

        found = {"two_calls": two_calls}
    return {name: (lambda s, t, m, hard, _fn=fn: chunks(_fn, s, t, m, hard))
            for name, fn in found.items()}


def precision(torch, cs, label, routes):
    cases = [dict(b=70_000, n=8, seed=36 + i, case="random", hard=h)
             for i in range(5) for h in (True, False)]
    cases += [dict(b=16, n=n, seed=n, case="random", hard=h)
              for n in (30, 1000, 8192) for h in (True, False)]
    cases += [dict(b=b, n=n, seed=int(gap), case=f"well-ranked-{gap:g}", hard=True)
              for gap in (4.0, 10.0, 20.0) for b, n in ((16, 30), (4, 1000))]
    rows = []
    for c in cases:
        s, t, m = cs.pairwise_inputs(torch, c["b"], c["n"], seed=c["seed"], case=c["case"])
        ref_loss, ref_grad = cs.pairwise_plain(torch, s.double(), t.double(), m.double(),
                                               c["hard"])
        g_max = ref_grad.abs().max(1).values
        for route, fn in routes.items():
            loss, grad = fn(s, t, m, c["hard"])
            e_loss = (loss.double() - ref_loss).abs()
            row = dict(source=label, route=route, b=c["b"], n=c["n"], seed=c["seed"],
                       case=c["case"], targets="hard" if c["hard"] else "soft",
                       loss_rows_failing=int((e_loss > cs.TOL * ref_loss.abs().clamp(
                           min=1.0)).sum()))
            if c["case"] != "random":
                row["loss_rel_rows_failing"] = int((e_loss > cs.TOL * ref_loss.abs()).sum())
                row["loss_worst_rel"] = float((e_loss / ref_loss.abs()).max())
            if grad is not None:
                e_grad = (grad.double() - ref_grad).abs().max(1).values
                share = torch.where(g_max > 0, e_grad / g_max.clamp(min=1e-300),
                                    torch.where(e_grad > 0, torch.inf, 0.0))
                worst = int(share.argmax())
                row.update(grad_rows_failing=int((e_grad > cs.TOL * g_max).sum()),
                           grad_worst_share=float(share[worst]),
                           grad_worst_row=[float(e_grad[worst]), float(g_max[worst])])
            rows.append(row)
            cs.emit(phase="precision", **row)
    verdict = {}
    for route in routes:
        for targets in ("hard", "soft"):
            mine = [r for r in rows if r["route"] == route and r["targets"] == targets]
            rand = [r for r in mine if r["case"] == "random"]
            ranked = [r for r in mine if r["case"] != "random"]
            v = dict(cohorts=sum(r["b"] for r in rand),
                     loss_rows_failing=sum(r["loss_rows_failing"] for r in mine))
            if ranked:
                v.update(well_ranked_cohorts=sum(r["b"] for r in ranked),
                         loss_rel_rows_failing=sum(r["loss_rel_rows_failing"]
                                                   for r in ranked),
                         loss_worst_rel=max(r["loss_worst_rel"] for r in ranked))
            if "grad_rows_failing" in mine[0]:
                v.update(grad_rows_failing=sum(r["grad_rows_failing"] for r in mine),
                         grad_worst_share=max(r["grad_worst_share"] for r in mine))
            verdict[f"{route}/{targets}"] = v
    return verdict


def measure(label: str) -> dict:
    """Runs inside the tree's own process."""
    import torch

    sys.path.append(str(ROOT))                  # this checkout's chip_smoke helpers
    import chip_smoke as cs
    from repro_torch.kernels.pairwise_rank import kernel as pk

    pk.LIBRARY.build()
    routes = routes_of(torch, pk)
    out = {"label": label, "source": str(pk.LIBRARY.source), "routes": list(routes),
           "precision": precision(torch, cs, label, routes), "ms": {}}
    for shape, b, n in SHAPES:
        s, t, m = cs.pairwise_inputs(torch, b, n, seed=b + n, masked_frac=0.0)
        out["ms"][shape] = {name: cs.cuda_ms(torch, lambda: fn(s, t, m, True))
                            for name, fn in routes.items()}
        if "two_calls" in routes:               # each launch of the two alone
            _, count = pk.pairwise_rank_fwd_cuda(s[:CHUNK], t[:CHUNK], m[:CHUNK], hard=True)
            g = torch.ones_like(count, dtype=torch.float32)
            out["ms"][shape]["loss_launch"] = cs.cuda_ms(torch, lambda: [
                pk.pairwise_rank_fwd_cuda(s[r:r + CHUNK], t[r:r + CHUNK], m[r:r + CHUNK],
                                          hard=True) for r in range(0, b, CHUNK)])
            if b <= CHUNK:
                out["ms"][shape]["gradient_launch"] = cs.cuda_ms(
                    torch, lambda: pk.pairwise_rank_bwd_cuda(s, t, m, count, g, hard=True))
        cs.emit(phase="timing", source=label, shape=shape, ms=out["ms"][shape])
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("pairwise_rank_precision: this script needs a CUDA card")
    if len(argv) == 2 and argv[0] == "--measure":
        print(json.dumps(measure(argv[1])), flush=True)
        return 0
    trees = [a.split("=", 1) for a in argv] or [["current", str(ROOT)]]
    for label, root in trees:
        root = Path(root).resolve()
        env = dict(os.environ, PYTHONPATH=str(root / "src"))
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--measure", label], env=env, cwd=root,
                              capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"{label}: exit {proc.returncode}")
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(out.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
