"""Paper Fig. 2 + Fig. 3: GreenServ vs. static/random/MAB baselines.

The offline replay (``run``) reproduces the paper's headline table with
the router's ``route()`` loop alone over the calibrated outcome tables.
``run_closed_loop`` re-runs the headline comparison — GreenServ vs. the
random baseline over the 16-model paper pool — through the *full*
serving stack on a virtual clock: ``PoolServer.enqueue`` → GreenCache
(semantic + prefix) → ``route_batch`` with the cost-model tilt →
energy-budget governor under a diurnal carbon signal.  ``main`` is the
JAX package's ``benchmarks/bench_baselines.py::main``: both drives, its
lines, the ``--smoke`` ordering assertions through the closed loop and
the ``BENCH_baselines.json`` artifact (``common.write_bench_artifact``).

    PYTHONPATH=src python -m repro_torch.benchmarks.baselines [--smoke] \
        [--per-task N] [--artifact f] [--device cpu]

runs on the card (``--device cpu`` for the CPU); ``--rows`` prints only
the offline table of the rows named (e.g. ``--rows ctx-thompson``), with
each row's decision ms.
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.benchmarks.common import (RunResult, make_closed_loop_router,
                                           make_router, run_policy,
                                           run_record, run_scenario, stream,
                                           write_bench_artifact)
from repro_torch.configs.pool import build_paper_pool
from repro_torch.core.types import TaskType
from repro_torch.data import OutcomeSimulator
from repro_torch.data.scenarios import steady

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


def run_closed_loop(per_task: int = 200, seed: int = 0, lam: float = 0.4,
                    budget_frac: float = 0.8,
                    semantic_threshold: float = 0.97,
                    carbon_amplitude: float = 0.3,
                    device=None) -> Dict[str, dict]:
    """GreenServ vs. random through the full serving stack: the paper's
    16-model pool, steady Poisson arrivals under a diurnal carbon cycle,
    semantic + prefix caching, cost model, and the budget governor (both
    policies get the identical budget — governance that only GreenServ's
    λ integrator can act on is exactly the paper's deployment story).
    The routers run on ``device`` (None: the card) with featurize
    "auto"."""
    scenario = steady(per_task=per_task, seed=seed,
                      carbon_amplitude=carbon_amplitude)
    sim = OutcomeSimulator(seed=seed + 7)
    # budget anchored to the random policy's expected spend over the
    # outcome simulator's latent means: uniform arm choice × mean Wh
    names = build_paper_pool().names
    mean_wh = float(np.mean([sim.oracle_tables(names, t)[1]
                             for t in TaskType]))
    out: Dict[str, dict] = {}
    for policy in ("greenserv", "random"):
        router = make_closed_loop_router(policy=policy, lam=lam, seed=seed,
                                         fit_classifier=True, device=device)
        res = run_scenario(
            scenario, router, outcome_fn=OutcomeSimulator(seed=seed + 7),
            seed=seed, name=f"closed_loop_{policy}", cache_mode="full",
            # the synthetic stream is heavily templated: at the default
            # 0.92 threshold ~85% of queries replay from the semantic
            # cache and routing barely runs — 0.97 keeps the layer live
            # for near-exact duplicates only
            semantic_threshold=semantic_threshold,
            budget_wh_per_query=budget_frac * mean_wh,
            admission_planner=True, concurrency=4)
        out[policy] = run_record(res)
    return out


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
        lines.append(paper_targets(results["greenserv-linucb"],
                                   results["random"]))
    return lines


def paper_targets(gs: RunResult, rnd: RunResult) -> str:
    """The line with GreenServ's accuracy and Wh against random beside
    the paper's +22% / -31%."""
    return (f"# paper targets: +22% acc / -31% energy vs random -> got "
            f"{100 * (gs.mean_accuracy / rnd.mean_accuracy - 1):+.1f}% acc, "
            f"{100 * (gs.total_energy_wh / rnd.total_energy_wh - 1):+.1f}% "
            f"energy")


def main(per_task: int = 500, seed: int = 0,
         artifact: Optional[str] = "BENCH_baselines.json",
         smoke: bool = False,
         closed_per_task: Optional[int] = None,
         device=None) -> List[str]:
    # ~1000 closed-loop queries (16 arms need that much feedback for the
    # bandit to separate from random with real margin); decoupled from
    # the offline sweep's scale
    closed_per_task = closed_per_task or max(per_task // 5, 200)
    results = run(per_task=per_task, seed=seed, device=device)
    lines = ["name,mean_norm_accuracy,total_energy_wh,cumulative_regret"]
    for name, r in results.items():
        lines.append(f"{name},{r.mean_accuracy:.4f},"
                     f"{r.total_energy_wh:.2f},{r.cumulative_regret:.1f}")
    gs, rnd = results["greenserv-linucb"], results["random"]
    lines.append(paper_targets(gs, rnd))
    closed = run_closed_loop(per_task=closed_per_task, seed=seed,
                             device=device)
    cgs, crnd = closed["greenserv"], closed["random"]
    for policy, rec in closed.items():
        lines.append(
            f"closed-loop-{policy},acc={rec['mean_accuracy']:.3f},"
            f"wh={rec['total_energy_wh']:.2f},"
            f"completed={rec['completed']}/{rec['n_queries']},"
            f"cache_hits={rec['stats']['cache_hits']}")
    if smoke:
        check_closed_loop_ordering(cgs, crnd)
        lines.append(
            "smoke,closed-loop ordering holds,"
            f"acc {cgs['mean_accuracy']:.3f}>={crnd['mean_accuracy']:.3f},"
            f"wh {cgs['total_energy_wh']:.2f}<{crnd['total_energy_wh']:.2f}")
    if artifact:
        runs = {name: {
            "mean_accuracy": float(r.mean_accuracy),
            "total_energy_wh": float(r.total_energy_wh),
            "cumulative_regret": float(r.cumulative_regret),
            "trajectory": [
                {"t": int(i), "cumulative_regret": float(v)}
                for i, v in enumerate(r.regret_curve)][::max(
                    len(r.regret_curve) // 50, 1)],
        } for name, r in results.items()}
        runs["closed_loop_greenserv"] = cgs
        runs["closed_loop_random"] = crnd
        write_bench_artifact(
            artifact, bench="baselines", seed=seed,
            headline={
                "acc_gain_vs_random":
                    gs.mean_accuracy / rnd.mean_accuracy - 1.0,
                "energy_vs_random":
                    gs.total_energy_wh / rnd.total_energy_wh - 1.0,
                "closed_loop_acc_gain":
                    cgs["mean_accuracy"] - crnd["mean_accuracy"],
                "closed_loop_energy_ratio":
                    cgs["total_energy_wh"]
                    / max(crnd["total_energy_wh"], 1e-9)},
            runs=runs)
        lines.append(f"artifact,path,{artifact}")
    return lines


def check_closed_loop_ordering(gs: dict, rnd: dict) -> None:
    """``--smoke``'s paper-shaped ordering through the serving stack:
    GreenServ answers every query, at no lower accuracy than random and
    with fewer Wh (run records, ``common.run_record``)."""
    if gs["completed"] != gs["n_queries"]:
        raise AssertionError(f"closed loop lost requests: "
                             f"{gs['completed']}/{gs['n_queries']}")
    if not gs["mean_accuracy"] >= rnd["mean_accuracy"] - 1e-9:
        raise AssertionError(
            f"GreenServ accuracy {gs['mean_accuracy']:.3f} below random "
            f"{rnd['mean_accuracy']:.3f} through the serving stack")
    if not gs["total_energy_wh"] < rnd["total_energy_wh"]:
        raise AssertionError(
            f"GreenServ energy {gs['total_energy_wh']:.2f} Wh not below "
            f"random {rnd['total_energy_wh']:.2f} Wh")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-task", type=int, default=None,
                    help="stream queries per task family "
                         "(default 500, or 60 with --smoke)")
    ap.add_argument("--artifact", default="BENCH_baselines.json",
                    help="trajectory artifact path ('' disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down run asserting GreenServ >= random "
                         "accuracy with lower Wh through the closed loop")
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    ap.add_argument("--rows", nargs="+", default=None, metavar="ROW",
                    help=f"print only the offline table of these rows "
                         f"(of {', '.join(ROWS)})")
    args = ap.parse_args()
    per_task = args.per_task if args.per_task is not None else (
        60 if args.smoke else 500)
    if args.rows:
        print("\n".join(table(run(per_task=per_task, seed=args.seed,
                                  rows=args.rows, device=args.device))))
    else:
        print("\n".join(main(per_task=per_task, seed=args.seed,
                             artifact=args.artifact or None,
                             smoke=args.smoke, device=args.device)))
