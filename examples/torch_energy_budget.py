"""Energy-budget governance demo: the same stream served twice — once
ungoverned at λ=0.4, once with an EnergyBudgetGovernor holding a Wh cap at
60% of what the first run spent.  Watch λ tighten as the budget depletes
and the router shift to cheaper pool members.  The PyTorch package's twin
of ``examples/energy_budget.py``: the same flags and lines, plus
``--device`` (the routers' device; default: the card).

    PYTHONPATH=src python examples/torch_energy_budget.py [--per-task 300] \
        [--device cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.benchmarks.common import drive_pool_stream
from repro_torch.data.stream import make_stream
from repro_torch.telemetry import (EnergyBudgetGovernor, Telemetry,
                                   diurnal_carbon_intensity)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-task", type=int, default=300)
    ap.add_argument("--budget-frac", type=float, default=0.6)
    ap.add_argument("--carbon", action="store_true",
                    help="scale the budget refill by a diurnal carbon signal")
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args(argv)

    def serve(queries, telemetry):
        res = drive_pool_stream(queries, telemetry, batch=10,
                                fit_classifier=True, device=args.device)
        return res.mean_accuracy, res.total_energy_wh, res.server.router

    queries = make_stream(per_task=args.per_task)
    print(f"serving {len(queries)} queries, ungoverned (λ=0.4) ...")
    acc_u, wh_u, _ = serve(queries, Telemetry())
    print(f"  ungoverned: acc {acc_u:.3f}, {wh_u:.2f} Wh "
          f"({wh_u / len(queries) * 1e3:.1f} mWh/query)")

    budget = args.budget_frac * wh_u
    carbon = diurnal_carbon_intensity if args.carbon else None
    governor = EnergyBudgetGovernor(budget, horizon_queries=len(queries),
                                    gain=0.005, lambda_max=0.8,
                                    carbon_fn=carbon)
    telemetry = Telemetry(governor=governor)
    print(f"re-serving under a {budget:.2f} Wh cap "
          f"({args.budget_frac:.0%} of ungoverned) ...")
    acc_g, wh_g, router = serve(queries, telemetry)
    print(f"  governed:   acc {acc_g:.3f}, {wh_g:.2f} Wh "
          f"({wh_g / len(queries) * 1e3:.1f} mWh/query)")
    print(f"  under cap: {wh_g <= budget}   "
          f"accuracy retained: {acc_g / max(acc_u, 1e-9):.1%}")

    hist = governor.lambda_history
    if hist:
        lams = [lam for _, lam in hist]
        print(f"  λ trajectory: start 0.400 → peak {max(lams):.3f} → "
              f"final {lams[-1]:.3f}  ({len(hist)} adjustments)")
    print()
    print(telemetry.summary())
    return {"ungoverned": (acc_u, wh_u), "governed": (acc_g, wh_g),
            "budget_wh": budget, "lambda_history": list(hist)}


if __name__ == "__main__":
    main()
