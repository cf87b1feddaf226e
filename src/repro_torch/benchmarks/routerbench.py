"""Paper Table 1 (§6.3.6): the RouterBench scorecard, offline.

The router's ``route()`` loop per willingness-to-pay point over the
synthetic RouterBench table (``repro_torch.data.routerbench``): AIQ, peak
and mean accuracy, as the paper reports them.

    PYTHONPATH=src python -m repro_torch.benchmarks.routerbench [--smoke]

runs ``linucb``, ``eps_greedy_ctx`` and ``cts`` (the JAX package's
``greenserv-linucb``, ``ctx-eps-greedy`` and ``thompson`` rows) on the
card (``--device cpu`` for the CPU).  The JAX package's closed loop over
the same table (``run_closed_loop``) waits for the cost-model and
telemetry slices.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, ModelProfile, Query, RouterConfig
from repro_torch.data.routerbench import (RouterBenchTable, aiq, build_table,
                                          query_text)

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
                  device=None) -> dict:
    """Scorecard for one bandit algorithm across the WTP sweep: AIQ, peak
    and mean accuracy, plus the per-WTP (cost, accuracy) frontier points.

    The task classifier is fit once and shared across the sweep — every
    WTP point sees identical training data, so refitting per point would
    give bitwise the same classifier."""
    table = build_table(n_per_task=n_per_task, seed=seed)
    cost_scale = float(np.percentile(table.cost, 90))
    points, accs = [], []
    fitted = None
    for wtp in wtps:
        router = GreenServRouter(
            _rb_config(wtp, algorithm, seed, cost_scale),
            _rb_pool(table), device=device)
        if fitted is None:
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


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n-per-task", type=int, default=None,
                    help="table queries per task family "
                         "(default 150, or 40 with --smoke)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args()
    n = args.n_per_task or (40 if args.smoke else 150)
    print("algorithm,aiq,peak_acc,avg_acc  (paper: 0.607, 0.757, 0.717)")
    for algo in ALGORITHMS:
        r = run_algorithm(algo, n_per_task=n, seed=args.seed,
                          device=args.device)
        print(f"{ROW_NAMES[algo]},{r['aiq']:.4f},{r['peak_acc']:.4f},"
              f"{r['avg_acc']:.4f}")
