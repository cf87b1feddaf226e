"""Paper Tables 3 and 4: the routing overhead a query (each contextual
feature and each policy's decision, ms) and that overhead against each
paper-pool model's modeled median latency.

On the card with featurize "auto", LinUCB's router featurizes through the
fused device path: its time is the ``fused_featurize`` row (the task and
cluster rows are then 0); the host path times the three features apart.

    PYTHONPATH=src python -m repro_torch.benchmarks.overhead \
        [--queries 300] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import List

from repro_torch.benchmarks.common import make_router, stream
from repro_torch.configs.pool import PAPER_POOL, make_profile
from repro_torch.core.types import Feedback
from repro_torch.data import OutcomeSimulator

ROUTERS = {"linucb": dict(algorithm="linucb"),
           "eps_greedy": dict(algorithm="eps_greedy",
                              features=(False, False, False)),
           "cts": dict(algorithm="cts")}


def run(n_queries: int = 300, device=None):
    """(LinUCB's per-feature ms a query, each policy's decision ms a
    query), each router replaying the same stream with feedback."""
    qs = stream(per_task=max(n_queries // 5, 1))[:n_queries]
    sim = OutcomeSimulator(seed=3)
    decision_ms = {}
    feature_ms = None
    for name, kw in ROUTERS.items():
        router = make_router(device=device, **kw)
        for q in qs:
            d = router.route(q)
            acc, e, lat, _ = sim(q, router.pool[d.model_index].name)
            router.feedback(Feedback(query_uid=q.uid,
                                     model_index=d.model_index, accuracy=acc,
                                     energy_wh=e, latency_ms=lat))
        decision_ms[name] = router.mean_decision_ms
        if name == "linucb":
            feature_ms = router.context.mean_overhead_ms()
    return feature_ms, decision_ms


def main(n_queries: int = 300, device=None) -> List[str]:
    feature_ms, decision_ms = run(n_queries, device=device)
    lines = ["component,ms_per_query"]
    lines.append(f"task_classification,{feature_ms['task']:.3f}")
    lines.append(f"semantic_cluster,{feature_ms['cluster']:.3f}")
    lines.append(f"complexity,{feature_ms['complexity']:.3f}")
    if feature_ms.get("featurize"):
        lines.append(f"fused_featurize,{feature_ms['featurize']:.3f}")
    for name, ms in decision_ms.items():
        lines.append(f"routing_decision[{name}],{ms:.3f}")
    total = sum(feature_ms.values()) + decision_ms["linucb"]
    lines.append(f"total_pre_inference,{total:.3f}")
    lines.append("# paper Table 4: total 6.68-7.77 ms/query")
    # Table 3 analogue: overhead relative to modeled median inference latency
    lines.append("model,median_latency_ms,overhead_pct")
    for name, _, params_b in PAPER_POOL:
        lat = make_profile(name, "x", params_b).latency_estimate_ms(8)
        lines.append(f"{name},{lat:.1f},{100 * total / lat:.1f}%")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--queries", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args()
    print("\n".join(main(args.queries, device=args.device)))
