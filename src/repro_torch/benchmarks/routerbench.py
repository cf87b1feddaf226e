"""Paper Table 1 (§6.3.6): RouterBench validation, offline + closed loop.

Two drives share the synthetic RouterBench table
(``repro_torch.data.routerbench``):

  * the *offline* WTP sweep (``run_algorithm``) — the router's ``route()``
    loop per willingness-to-pay point: AIQ, peak and mean accuracy, as
    the paper reports them;
  * the *closed loop* (``run_closed_loop``) — the same table behind the
    full serving stack: RouterBench-backed ``SimEngine``s behind
    ``PoolServer`` with prefix-KV caching, the energy governor and the
    cost model, GreenServ vs. the random baseline on identical arrival
    streams.  The semantic cache stays off: RouterBench texts are
    templated per task, and replaying a near-duplicate's cached answer
    would miscredit the per-instance table outcomes.

``main`` is the JAX package's ``benchmarks/bench_routerbench.py::main``:
``linucb``, ``eps_greedy_ctx`` and ``cts`` (its ``greenserv-linucb``,
``ctx-eps-greedy`` and ``thompson`` rows), the closed loop, the
``--smoke`` ordering assertions and the ``BENCH_routerbench.json``
artifact, on the card (``--device cpu`` for the CPU).

    PYTHONPATH=src python -m repro_torch.benchmarks.routerbench [--smoke] \
        [--per-task N] [--artifact f] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, ModelProfile, Query, RouterConfig
from repro_torch.benchmarks.baselines import check_closed_loop_ordering
from repro_torch.benchmarks.common import (make_closed_loop_router,
                                           run_record, run_scenario,
                                           write_bench_artifact)
from repro_torch.data.routerbench import (RouterBenchTable, aiq, build_table,
                                          query_text)
from repro_torch.data.scenarios import Scenario, poisson_arrivals

ALGORITHMS = ("linucb", "eps_greedy_ctx", "cts")
# the JAX package's row names (benchmarks/bench_routerbench.py)
ROW_NAMES = {"linucb": "greenserv-linucb", "eps_greedy_ctx": "ctx-eps-greedy",
             "cts": "thompson"}


def _rb_config(lam: float, algorithm: str, seed: int,
               cost_scale: float) -> RouterConfig:
    return RouterConfig(lam=lam, algorithm=algorithm, seed=seed,
                        energy_scale_wh=cost_scale, max_arms=16,
                        n_clusters=3, n_complexity_bins=3)


def _rb_pool(table: RouterBenchTable) -> ModelPool:
    return ModelPool([ModelProfile(name=m, family="rb", params_b=1.0)
                      for m in table.models])


def _fit_rb_classifier(router: GreenServRouter,
                       table: RouterBenchTable) -> None:
    """Task classifier fit on a small labeled slice (instruction lines
    identify the 9 task families, mapped onto 5 classifier classes)."""
    texts = [query_text(table, i) for i in range(0, 90)]
    labels = [int(table.task_of[i] % router.config.n_tasks)
              for i in range(0, 90)]
    router.context.task_classifier.fit(texts, labels, steps=100)


def run_algorithm(algorithm: str, wtps=(0.0, 0.1, 0.2, 0.4, 0.6, 0.8, 1.0),
                  n_per_task: int = 400, seed: int = 0,
                  refit_per_point: bool = False, device=None) -> dict:
    """Scorecard for one bandit algorithm across the WTP sweep: AIQ, peak
    and mean accuracy, plus the per-WTP (cost, accuracy) frontier points.

    The task classifier is fit once and shared across the sweep — every
    WTP point sees identical training data, so refitting per point
    (``refit_per_point``, kept for the test that holds the two equal)
    gives bitwise the same classifier."""
    table = build_table(n_per_task=n_per_task, seed=seed)
    cost_scale = float(np.percentile(table.cost, 90))
    points, accs = [], []
    fitted = None
    for wtp in wtps:
        router = GreenServRouter(
            _rb_config(wtp, algorithm, seed, cost_scale),
            _rb_pool(table), device=device)
        if fitted is None or refit_per_point:
            _fit_rb_classifier(router, table)
            fitted = router.context.task_classifier
        else:
            # routing only predicts; sharing the fitted object is exact
            router.context.task_classifier = fitted
        acc_sum = cost_sum = 0.0
        for i in range(table.n_queries):
            q = Query(uid=i, text=query_text(table, i))
            d = router.route(q)
            a = float(table.accuracy[i, d.model_index])
            c = float(table.cost[i, d.model_index])
            router.feedback(Feedback(query_uid=i, model_index=d.model_index,
                                     accuracy=a, energy_wh=c,
                                     latency_ms=1.0))
            acc_sum += a
            cost_sum += c
        points.append((cost_sum / table.n_queries,
                       acc_sum / table.n_queries))
        accs.append(acc_sum / table.n_queries)
    return {
        "aiq": aiq(points),
        "peak_acc": float(np.max(accs)),
        "avg_acc": float(np.mean(accs)),
        "n_queries": int(table.n_queries),
        "trajectory": [{"wtp": float(w), "cost_per_query": float(c),
                        "accuracy": float(a)}
                       for w, (c, a) in zip(wtps, points)],
    }


def run_closed_loop(n_per_task: int = 150, seed: int = 0, lam: float = 0.1,
                    rate_qps: float = 40.0, budget_frac: float = 0.8,
                    device=None) -> Dict[str, dict]:
    """GreenServ vs. random through the full serving stack over the
    RouterBench table: one shared arrival stream, per-policy PoolServer
    with prefix-KV cache, budget governor, and cost model active; the
    routers on ``device`` (None: the card)."""
    table = build_table(n_per_task=n_per_task, seed=seed)
    cost_scale = float(np.percentile(table.cost, 90))
    model_index = {m: j for j, m in enumerate(table.models)}
    latency_scale_ms = 40.0 / max(float(np.mean(table.cost)), 1e-9)

    def rb_outcome(q: Query, model: str):
        j = model_index[model]
        acc = float(table.accuracy[q.uid, j])
        cost = float(table.cost[q.uid, j])
        # latency proxy proportional to the table's per-query cost, so
        # expensive arms also pace the virtual clock slower
        return acc, cost, 20.0 + latency_scale_ms * cost, 8

    queries = [Query(uid=i, text=query_text(table, i))
               for i in range(table.n_queries)]
    scenario = Scenario(
        name="routerbench_closed_loop", queries=queries,
        arrivals_s=poisson_arrivals(len(queries), rate_qps, seed=seed + 1))
    # budget just below the random policy's expected spend: enough
    # pressure that governance matters, not enough to force the router
    # onto the cheap low-accuracy arms the whole run
    budget_per_query = budget_frac * float(np.mean(table.cost))
    out: Dict[str, dict] = {}
    for policy in ("greenserv", "random"):
        router = make_closed_loop_router(
            policy=policy, pool=_rb_pool(table),
            config=_rb_config(lam, "linucb", seed, cost_scale),
            fit_classifier=False, device=device)
        _fit_rb_classifier(router, table)
        res = run_scenario(
            scenario, router, outcome_fn=rb_outcome, seed=seed,
            name=f"closed_loop_{policy}", cache_mode="prefix",
            budget_wh_per_query=budget_per_query,
            admission_planner=True, concurrency=4)
        out[policy] = run_record(res)
    return out


def main(n_per_task: int = 150, seed: int = 0,
         artifact: Optional[str] = "BENCH_routerbench.json",
         smoke: bool = False,
         closed_n_per_task: Optional[int] = None,
         device=None) -> List[str]:
    # the closed loop needs ~900 queries for the bandit to separate from
    # random with real margin; the offline sweep converges much earlier,
    # so the two scales decouple (smoke: small sweep, full-size loop)
    closed_n_per_task = closed_n_per_task or max(n_per_task, 100)
    lines = ["algorithm,AIQ,peak_acc,avg_acc"]
    runs: Dict[str, dict] = {}
    for algo in ALGORITHMS:
        name = ROW_NAMES[algo]
        r = run_algorithm(algo, n_per_task=n_per_task, seed=seed,
                          device=device)
        runs[name] = r
        lines.append(f"{name},{r['aiq']:.3f},{100 * r['peak_acc']:.1f}%,"
                     f"{100 * r['avg_acc']:.1f}%")
    lines.append("# paper Table 1: GreenServ AIQ 0.607 / peak 75.7% / "
                 "avg 71.7%")
    closed = run_closed_loop(n_per_task=closed_n_per_task, seed=seed,
                             device=device)
    for policy, rec in closed.items():
        runs[f"closed_loop_{policy}"] = rec
        lines.append(
            f"closed-loop-{policy},acc={rec['mean_accuracy']:.3f},"
            f"wh={rec['total_energy_wh']:.1f},"
            f"completed={rec['completed']}/{rec['n_queries']}")
    gs, rnd = closed["greenserv"], closed["random"]
    if smoke:
        check_closed_loop_ordering(gs, rnd)
        lines.append(
            "smoke,closed-loop ordering holds,"
            f"acc {gs['mean_accuracy']:.3f}>={rnd['mean_accuracy']:.3f},"
            f"wh {gs['total_energy_wh']:.1f}<{rnd['total_energy_wh']:.1f}")
    if artifact:
        gsrun = runs["greenserv-linucb"]
        write_bench_artifact(
            artifact, bench="routerbench", seed=seed,
            headline={"greenserv_aiq": gsrun["aiq"],
                      "greenserv_peak_acc": gsrun["peak_acc"],
                      "greenserv_avg_acc": gsrun["avg_acc"],
                      "closed_loop_acc_gain":
                          gs["mean_accuracy"] - rnd["mean_accuracy"],
                      "closed_loop_energy_ratio":
                          gs["total_energy_wh"]
                          / max(rnd["total_energy_wh"], 1e-9)},
            runs=runs)
        lines.append(f"artifact,path,{artifact}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-task", type=int, default=None,
                    help="RouterBench queries per task family "
                         "(default 150, or 40 with --smoke)")
    ap.add_argument("--artifact", default="BENCH_routerbench.json",
                    help="trajectory artifact path ('' disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down run asserting GreenServ >= random "
                         "accuracy with lower Wh through the closed loop")
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args()
    per_task = args.per_task if args.per_task is not None else (
        40 if args.smoke else 150)
    print("\n".join(main(n_per_task=per_task, seed=args.seed,
                         artifact=args.artifact or None, smoke=args.smoke,
                         device=args.device)))
