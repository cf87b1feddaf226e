"""Paper Fig. 2 + Fig. 3: GreenServ vs. static/random/MAB baselines, the
offline replay (the router's ``route()`` loop alone over the calibrated
outcome tables).

    PYTHONPATH=src python -m repro_torch.benchmarks.baselines [--per-task N]

runs on the card (``--device cpu`` for the CPU); ``--rows`` picks rows
(e.g. ``--rows ctx-thompson``).  The JAX package's closed-loop drive
(``run_closed_loop``) waits for the cost-model and telemetry slices.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Sequence

from repro_torch.benchmarks.common import (RunResult, make_router,
                                           run_policy, stream)
from repro_torch.data import OutcomeSimulator

# name → (algorithm, features) of the bandit rows, in the JAX package's order
BANDIT_ROWS = {
    "greenserv-linucb": ("linucb", (True, True, True)),
    "ctx-eps-greedy": ("eps_greedy_ctx", (True, True, True)),
    "ctx-thompson": ("cts", (True, True, True)),
    "eps-greedy-nonctx": ("eps_greedy", (False, False, False)),
}
STATIC_ROWS = {"largest (yi-34b)": "yi-34b",
               "smallest (qwen2.5-0.5b)": "qwen2.5-0.5b",
               "accuracy (gemma-3-27b)": "gemma-3-27b"}
ROWS = (list(BANDIT_ROWS) + ["random"] + list(STATIC_ROWS))


def run(per_task: int = 500, seed: int = 0, lam: float = 0.4,
        rows: Sequence[str] = tuple(ROWS),
        device=None) -> Dict[str, RunResult]:
    unknown = set(rows) - set(ROWS)
    if unknown:
        raise ValueError(f"unknown rows {sorted(unknown)}; known: {ROWS}")
    qs = stream(per_task=per_task, seed=seed)
    results: Dict[str, RunResult] = {}
    for name in ROWS:
        if name not in rows:
            continue
        sim = OutcomeSimulator(seed=seed + 7)
        if name in BANDIT_ROWS:
            algorithm, features = BANDIT_ROWS[name]
            r = make_router(lam=lam, algorithm=algorithm, features=features,
                            seed=seed, device=device)
            results[name] = run_policy(r, qs, sim, name)
        elif name == "random":
            results[name] = run_policy(None, qs, sim, name,
                                       random_seed=seed + 3)
        else:
            results[name] = run_policy(None, qs, sim, name,
                                       static_model=STATIC_ROWS[name])
    return results


def table(results: Dict[str, RunResult]) -> List[str]:
    """The JAX package's CSV lines, with the paper's random-relative
    targets where both rows are present."""
    lines = ["name,mean_norm_accuracy,total_energy_wh,cumulative_regret,"
             "mean_decision_ms"]
    for name, r in results.items():
        lines.append(f"{name},{r.mean_accuracy:.4f},"
                     f"{r.total_energy_wh:.2f},{r.cumulative_regret:.1f},"
                     f"{r.mean_decision_ms:.4f}")
    if "greenserv-linucb" in results and "random" in results:
        gs, rnd = results["greenserv-linucb"], results["random"]
        lines.append(
            f"# paper targets: +22% acc / -31% energy vs random -> got "
            f"{100 * (gs.mean_accuracy / rnd.mean_accuracy - 1):+.1f}% acc, "
            f"{100 * (gs.total_energy_wh / rnd.total_energy_wh - 1):+.1f}% "
            f"energy")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-task", type=int, default=500,
                    help="stream queries per task family (default 500)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    ap.add_argument("--rows", nargs="+", default=ROWS, metavar="ROW",
                    help=f"rows to run (default all: {', '.join(ROWS)})")
    args = ap.parse_args()
    print("\n".join(table(run(per_task=args.per_task, seed=args.seed,
                              rows=args.rows, device=args.device))))
