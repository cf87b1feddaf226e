"""Paper Fig. 4 (Appendix A.4): the accuracy-energy trade-off across λ.

The offline replay (``common.run_policy``) of GreenServ (LinUCB) over the
16-model paper pool at each λ, ``n_runs`` seeds each, averaged.

    PYTHONPATH=src python -m repro_torch.benchmarks.lambda_sweep \
        [--per-task 200] [--runs 2] [--device cpu]

runs the routers on the card (``--device cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
from typing import List, Sequence

import numpy as np

from repro_torch.benchmarks.common import make_router, run_policy, stream
from repro_torch.data import OutcomeSimulator

LAMBDAS = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def run(lams: Sequence[float] = LAMBDAS, per_task: int = 200,
        n_runs: int = 3, device=None) -> List[tuple]:
    """(λ, mean accuracy, mean total Wh) per λ over ``n_runs`` seeds."""
    qs = stream(per_task=per_task)
    rows = []
    for lam in lams:
        accs, energies = [], []
        for run_i in range(n_runs):
            router = make_router(lam=lam, seed=run_i, device=device)
            sim = OutcomeSimulator(seed=run_i + 100)
            r = run_policy(router, qs, sim, f"lam{lam}")
            accs.append(r.mean_accuracy)
            energies.append(r.total_energy_wh)
        rows.append((lam, float(np.mean(accs)), float(np.mean(energies))))
    return rows


def main(per_task: int = 200, n_runs: int = 2, device=None) -> List[str]:
    rows = run(per_task=per_task, n_runs=n_runs, device=device)
    lines = ["lambda,mean_norm_accuracy,total_energy_wh"]
    for lam, acc, e in rows:
        lines.append(f"{lam:.1f},{acc:.4f},{e:.2f}")
    accs = [r[1] for r in rows]
    es = [r[2] for r in rows]
    mono_acc = all(a >= b - 0.06 for a, b in zip(accs, accs[1:]))
    mono_e = all(a >= b - 3.0 for a, b in zip(es, es[1:]))
    lines.append(f"# monotone: accuracy~decreasing={mono_acc} "
                 f"energy~decreasing={mono_e} (paper Fig. 9)")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-task", type=int, default=200)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args()
    print("\n".join(main(per_task=args.per_task, n_runs=args.runs,
                         device=args.device)))
