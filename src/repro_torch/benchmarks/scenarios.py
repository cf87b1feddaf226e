"""Scenario lab: paper-shaped traffic through the full serving stack.

Drives the composable scenario generators (``repro_torch.data.scenarios``)
through the closed loop — ``PoolServer.enqueue`` → GreenCache →
``route_batch`` → governor — on a virtual clock, one BENCH artifact per
scenario (uniform schema):

  * ``flash_crowd``      — MMPP bursts ~10x past the pool's service rate
    under a diurnal carbon cycle, budget governor + energy-aware
    admission planner on.  The run must drain without ``LivelockError``:
    admission pressure may slow the pool, never stop it.
  * ``duplicate_flood``  — adversarial near-duplicate bursts against the
    semantic cache; the flood must be served largely from cache (hits,
    zero engine Wh) with nothing lost.
  * ``pool_churn``       — an engine killed mid-run plus the held-out
    §6.2.4 model joining via ``add_engine``; no request may be lost
    across either membership change, and the router must end the run
    with the grown arm count.

``--smoke`` scales down and asserts each scenario's invariant.  The
routers run on ``device`` (None: the card; ``--device cpu`` for the CPU)
with featurize "auto".

    PYTHONPATH=src python -m repro_torch.benchmarks.scenarios [--smoke]
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.benchmarks.common import (ClosedLoopResult,
                                           make_closed_loop_router,
                                           run_record, run_scenario,
                                           write_bench_artifact)
from repro_torch.configs.pool import build_paper_pool
from repro_torch.core.types import TaskType
from repro_torch.data import OutcomeSimulator
from repro_torch.data.scenarios import (duplicate_flood, flash_crowd,
                                        pool_churn)


def _paper_pool_budget(seed: int) -> float:
    """Per-query Wh anchor: the random policy's expected spend over the
    outcome simulator's latent means (uniform arm choice × mean Wh)."""
    sim = OutcomeSimulator(seed=seed + 7)
    names = build_paper_pool().names
    return float(np.mean([sim.oracle_tables(names, t)[1]
                          for t in TaskType]))


def run_flash_crowd(per_task: int = 100, seed: int = 0, device=None
                    ) -> Tuple[ClosedLoopResult, List[str]]:
    scenario = flash_crowd(per_task=per_task, seed=seed)
    router = make_closed_loop_router(lam=0.4, seed=seed, device=device)
    res = run_scenario(scenario, router, seed=seed,
                       outcome_fn=OutcomeSimulator(seed=seed + 7),
                       cache_mode="full", semantic_threshold=0.97,
                       budget_wh_per_query=0.8 * _paper_pool_budget(seed),
                       admission_planner=True)
    checks = [
        (res.completed == res.n_queries,
         f"flash crowd drained {res.completed}/{res.n_queries} — the "
         "admission planner must never livelock the pool"),
    ]
    return res, _assert_or_report(checks)


def run_duplicate_flood(per_task: int = 60, seed: int = 0, device=None
                        ) -> Tuple[ClosedLoopResult, List[str]]:
    scenario = duplicate_flood(per_task=per_task, seed=seed)
    router = make_closed_loop_router(lam=0.4, seed=seed, device=device)
    res = run_scenario(scenario, router, seed=seed,
                       outcome_fn=OutcomeSimulator(seed=seed + 7),
                       cache_mode="full")
    checks = [
        (res.completed == res.n_queries,
         f"flood drained {res.completed}/{res.n_queries}"),
        (res.stats["cache_hits"] > 0,
         "near-duplicate flood produced zero semantic hits"),
    ]
    return res, _assert_or_report(checks)


def run_pool_churn(per_task: int = 60, seed: int = 0, device=None
                   ) -> Tuple[ClosedLoopResult, List[str]]:
    scenario = pool_churn(per_task=per_task, seed=seed)
    router = make_closed_loop_router(lam=0.4, seed=seed,
                                     exclude=scenario.exclude, device=device)
    n_arms_start = len(router.pool.names)
    res = run_scenario(scenario, router, seed=seed,
                       outcome_fn=OutcomeSimulator(seed=seed + 7),
                       cache_mode="full", semantic_threshold=0.97)
    checks = [
        (res.completed == res.n_queries,
         f"churn lost requests: {res.completed}/{res.n_queries}"),
        (res.stats["restarts"] >= 1,
         "engine kill never surfaced as a restart"),
        (len(router.pool.names) == n_arms_start + 1,
         f"add_engine did not grow the pool "
         f"({n_arms_start} -> {len(router.pool.names)})"),
    ]
    return res, _assert_or_report(checks)


def _assert_or_report(checks) -> List[str]:
    failures = [msg for ok, msg in checks if not ok]
    if failures:
        raise AssertionError("; ".join(failures))
    return [msg for _, msg in checks]


SCENARIOS: Dict[str, Callable] = {
    "flash_crowd": run_flash_crowd,
    "duplicate_flood": run_duplicate_flood,
    "pool_churn": run_pool_churn,
}

_SMOKE_PER_TASK = {"flash_crowd": 40, "duplicate_flood": 30,
                   "pool_churn": 30}
_FULL_PER_TASK = {"flash_crowd": 100, "duplicate_flood": 60,
                  "pool_churn": 60}


def main(scenarios: Optional[List[str]] = None, seed: int = 0,
         smoke: bool = False, per_task: Optional[int] = None,
         artifact_prefix: Optional[str] = "BENCH_scenario_",
         device=None) -> List[str]:
    names = scenarios or list(SCENARIOS)
    lines = ["scenario,completed,accuracy,wh,cache_hits,restarts,deferred"]
    for name in names:
        n = per_task or (_SMOKE_PER_TASK if smoke else _FULL_PER_TASK)[name]
        res, _ = SCENARIOS[name](per_task=n, seed=seed, device=device)
        lines.append(
            f"{name},{res.completed}/{res.n_queries},"
            f"{res.mean_accuracy:.3f},{res.total_energy_wh:.2f},"
            f"{res.stats['cache_hits']},{res.stats['restarts']},"
            f"{res.stats['deferred']}")
        if artifact_prefix:
            path = f"{artifact_prefix}{name}.json"
            write_bench_artifact(
                path, bench=f"scenario_{name}", seed=seed,
                headline={"mean_accuracy": res.mean_accuracy,
                          "total_energy_wh": res.total_energy_wh,
                          "completed_frac":
                              res.completed / max(res.n_queries, 1)},
                runs={name: run_record(res)})
            lines.append(f"artifact,path,{path}")
    if smoke:
        lines.append("smoke,all scenario invariants hold")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenario", action="append", choices=list(SCENARIOS),
                    help="run one scenario (repeatable; default: all)")
    ap.add_argument("--per-task", type=int, default=None,
                    help="stream queries per task family (default: "
                         "per-scenario)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down run; scenario invariants still "
                         "asserted")
    ap.add_argument("--artifact-prefix", default="BENCH_scenario_",
                    help="artifact path prefix ('' disables)")
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args()
    print("\n".join(main(scenarios=args.scenario, seed=args.seed,
                         smoke=args.smoke, per_task=args.per_task,
                         artifact_prefix=args.artifact_prefix or None,
                         device=args.device)))
