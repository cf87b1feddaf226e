"""Fleet weak-scaling: sharded engine pools under a shard-kill event.

Virtual-clock SimEngine fleet: every shard is a full replica of an
8-model paper-pool subset behind its own ``PoolServer``/router; the
``FleetController`` load-balances arrivals, all-reduces bandit statistics
every few ticks, and fails a killed shard over through the heartbeat
path.  The routers run on ``device`` (None: the card; ``--device cpu``
for the CPU) with ``featurize`` "auto" (the device path on the card) or
"host"; the engines are simulated, so the fleet's shards share whatever
device the routers are on.

Weak scaling: ``n`` shards receive ``n×`` the queries at ``n×`` the
arrival rate, so ideal scaling keeps the span flat and throughput grows
linearly.  Every multi-shard run takes a mid-stream shard kill — queries
dispatched into the detection window are recovered by fail-over, so the
zero-lost assertion exercises the real redispatch path, not an idle
victim.

``--smoke`` (CI) runs {1, 4} shards and asserts:

* zero lost requests in every run (completed == dispatched), with the
  4-shard run's fail-over actually redispatching stranded queries;
* ≥3× throughput at 4 shards vs 1 — near-linear despite the kill;
* mean routing decision time ≤1.5× the single-shard run's (flat router
  overhead: each replica routes its own slice).

Full mode sweeps {1, 2, 4, 8}.  Emits ``BENCH_pool_scale.json``.

    PYTHONPATH=src python -m repro_torch.benchmarks.pool_scale --smoke
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from repro_torch.benchmarks.common import (ENERGY_SCALE_WH,
                                           make_closed_loop_router,
                                           write_bench_artifact)
from repro_torch.configs.pool import build_paper_pool
from repro_torch.core.pool import ModelPool
from repro_torch.core.types import RouterConfig
from repro_torch.data.profiles import OutcomeSimulator
from repro_torch.data.scenarios import poisson_arrivals
from repro_torch.data.stream import make_stream
from repro_torch.device import resolve_device
from repro_torch.fleet import (base_model_name, build_fleet, drive_fleet,
                               plan_fleet)
from repro_torch.serving.engine import SimEngine

# 8-model subset: drop the largest families so the virtual clock isn't
# dominated by early exploration of 30b+ latencies (the scaling shape,
# not the pool economics, is what this bench measures)
EXCLUDE = ["yi-34b", "gemma-3-27b", "qwen2.5-14b", "phi-4-14b",
           "gemma-3-12b", "llama-3.1-8b", "qwen2.5-7b", "mistral-7b"]

# requests span multiple ticks (steps_per_query) so a kill catches
# in-flight work; concurrency keeps shard capacity above the calm rate
STEPS_PER_QUERY = 2
CONCURRENCY = 4
SYNC_EVERY = 4
HEARTBEAT_TIMEOUT_S = 0.3
KILL_FRAC = 0.4          # kill lands at this fraction of the arrivals


def run_fleet(n_shards: int, per_shard: int, base_rate_qps: float,
              seed: int, kill: bool, device=None,
              featurize: str = "auto") -> dict:
    """One closed-loop fleet run; returns the uniform run record."""
    device = resolve_device(device)
    clk = {"t": 0.0}
    clock = lambda: clk["t"]  # noqa: E731
    sim = OutcomeSimulator(seed=seed + 3)
    # adopted engines are named <base>@<dead-shard>; outcomes key on base
    outcome = lambda q, m: sim(q, base_model_name(m))  # noqa: E731
    pool_names = [p.name for p in build_paper_pool(exclude=EXCLUDE)]
    plan = plan_fleet(n_shards, pool_names, devices=[device])

    def router_factory(spec):
        cfg = RouterConfig(lam=0.4, seed=seed + spec.index,
                           energy_scale_wh=ENERGY_SCALE_WH, max_arms=24,
                           featurize=featurize)
        return make_closed_loop_router(
            config=cfg, pool=ModelPool(build_paper_pool(exclude=EXCLUDE)),
            fit_classifier=False, device=device)

    def engine_factory(profile, spec):
        return SimEngine(profile, outcome,
                         steps_per_query=STEPS_PER_QUERY,
                         concurrency=CONCURRENCY, clock=clock)

    controller = build_fleet(plan, router_factory, engine_factory,
                             sync_every=SYNC_EVERY,
                             heartbeat_timeout_s=HEARTBEAT_TIMEOUT_S,
                             clock=clock)
    n = per_shard * n_shards
    queries = make_stream(per_task=max(1, n // 5), seed=seed)[:n]
    arrivals = poisson_arrivals(len(queries), base_rate_qps * n_shards,
                                seed=seed + 1)
    events = []
    if kill and n_shards > 1:
        t_kill = arrivals[int(KILL_FRAC * len(arrivals))]
        victim = plan.shards[-1].name
        events.append((t_kill,
                       lambda: controller.kill_shard(victim)))
    trajectory = drive_fleet(controller, queries, arrivals, clk,
                             events=events)
    span = clk["t"]
    stats = dict(controller.stats)
    return {"n_shards": n_shards, "n_queries": len(queries),
            "completed": stats["completed"], "span_s": round(span, 3),
            "throughput_qps": round(len(queries) / span, 3),
            "mean_decision_ms": round(controller.mean_decision_ms, 4),
            "total_wh": round(controller.total_joules() / 3600.0, 3),
            "killed": bool(events), "stats": stats,
            "events": controller.events, "trajectory": trajectory,
            "unanswered": len(controller.unanswered)}


def main(per_shard: int = 150, base_rate_qps: float = 5.0, seed: int = 0,
         artifact: Optional[str] = "BENCH_pool_scale.json",
         smoke: bool = False, device=None,
         featurize: str = "auto") -> List[str]:
    sizes = [1, 4] if smoke else [1, 2, 4, 8]
    runs = {}
    lines = ["n_shards,killed,throughput_qps,span_s,decision_ms,"
             "completed,redispatched,syncs"]
    for n in sizes:
        rec = run_fleet(n, per_shard, base_rate_qps, seed,
                        kill=(n > 1), device=device, featurize=featurize)
        runs[f"shards{n}"] = rec
        lines.append(
            f"{n},{int(rec['killed'])},{rec['throughput_qps']:.2f},"
            f"{rec['span_s']:.2f},{rec['mean_decision_ms']:.3f},"
            f"{rec['completed']}/{rec['n_queries']},"
            f"{rec['stats']['redispatched']},{rec['stats']['syncs']}")
    base, four = runs["shards1"], runs["shards4"]
    scaling = four["throughput_qps"] / base["throughput_qps"]
    overhead_ratio = (four["mean_decision_ms"]
                      / max(base["mean_decision_ms"], 1e-9))
    lines.append(f"# 4-shard scaling x{scaling:.2f}, decision overhead "
                 f"x{overhead_ratio:.2f}, fail-over redispatched "
                 f"{four['stats']['redispatched']} with "
                 f"{four['unanswered']} lost")
    for name, rec in runs.items():
        assert rec["completed"] == rec["n_queries"], (
            f"{name} lost requests: "
            f"{rec['completed']}/{rec['n_queries']}")
        assert rec["unanswered"] == 0, f"{name} left unanswered queries"
    if smoke:
        assert four["stats"]["failovers"] == 1, four["stats"]
        assert four["stats"]["redispatched"] > 0, (
            "shard kill recovered no queries — fail-over path untested")
        assert scaling >= 3.0, (
            f"4-shard throughput only x{scaling:.2f} of single-shard "
            f"(need >=3x despite the shard kill)")
        assert overhead_ratio <= 1.5, (
            f"per-query decision time grew x{overhead_ratio:.2f} with "
            f"sharding (need <=1.5x)")
        lines.append(f"smoke,scaling x{scaling:.2f}>=3 with shard kill,"
                     f"overhead x{overhead_ratio:.2f}<=1.5,zero lost")
    if artifact:
        write_bench_artifact(
            artifact, bench="pool_scale", seed=seed,
            headline={"scaling_x4": scaling,
                      "decision_overhead_x4": overhead_ratio,
                      "lost_requests": sum(r["unanswered"]
                                           for r in runs.values()),
                      "redispatched_x4": four["stats"]["redispatched"]},
            runs=runs)
        lines.append(f"artifact,path,{artifact}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-shard", type=int, default=None,
                    help="queries per shard (weak scaling; default 150, "
                         "250 without --smoke)")
    ap.add_argument("--rate", type=float, default=5.0,
                    help="arrival rate per shard (qps)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--artifact", default="BENCH_pool_scale.json",
                    help="trajectory artifact path ('' disables)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: {1,4} shards, asserts >=3x scaling "
                         "under a shard kill with zero lost requests")
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args()
    per_shard = args.per_shard if args.per_shard is not None else (
        150 if args.smoke else 250)
    print("\n".join(main(per_shard=per_shard, base_rate_qps=args.rate,
                         seed=args.seed, artifact=args.artifact or None,
                         smoke=args.smoke, device=args.device)))
