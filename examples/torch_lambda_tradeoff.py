"""Sweep the λ accuracy↔energy knob and print the operating points
(paper Fig. 4) — the control surface an operator actually uses; the
PyTorch package's twin of ``examples/lambda_tradeoff.py``.

    PYTHONPATH=src python examples/torch_lambda_tradeoff.py [--device cpu]

The routers run on the card (featurize "auto") unless ``--device`` names
another device; the lines it prints are the JAX example's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.benchmarks.common import make_router, run_policy, stream
from repro_torch.data import OutcomeSimulator


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args(argv)

    qs = stream(per_task=100)
    rows = []
    print(f"{'λ':>4} {'accuracy':>9} {'energy(Wh)':>11}  policy mix (top-3)")
    for lam in (0.0, 0.2, 0.4, 0.6, 0.8, 1.0):
        router = make_router(lam=lam, seed=0, device=args.device)
        res = run_policy(router, qs, OutcomeSimulator(seed=9), f"lam={lam}")
        top = sorted(zip(router.pool.names, res.selections),
                     key=lambda kv: -kv[1])[:3]
        mix = ", ".join(f"{n}×{int(c)}" for n, c in top if c)
        print(f"{lam:4.1f} {res.mean_accuracy:9.3f} "
              f"{res.total_energy_wh:11.1f}  {mix}")
        rows.append((lam, res.mean_accuracy, res.total_energy_wh, mix))
    print("\nλ=0 chases accuracy (big models); λ=1 chases joules (small "
          "ones);\nthe bandit walks the Pareto front in between — no "
          "recalibration.")
    return rows


if __name__ == "__main__":
    main()
