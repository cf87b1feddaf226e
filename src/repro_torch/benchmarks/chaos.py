"""Chaos drill: the reliability layer under a seeded fault storm.

Drives the ``chaos`` scenario (``repro_torch.data.scenarios``) — steady
traffic while a ``fault_storm`` batters the pool: the target engine
serves garbage (NaN-grade, zero-accuracy) output through a mid-run
window and crashes twice inside it, background engines pick up stalls
and slow-step episodes — through the full closed loop twice with the
same seed and fault schedule:

  * ``reliability`` — deadlines + retries + per-arm circuit breakers on
    (``PoolServer(deadline_s=…, max_retries=…, breaker_config=…)``);
  * ``baseline``    — the same storm with the reliability layer off:
    garbage completes at zero accuracy, crashes replay through the
    legacy restart path, nothing times out.

Invariants asserted (``--smoke`` and full runs alike):

  * zero requests lost in both runs — every admitted uid lands in
    ``responses`` ∪ ``failed`` (the baseline has no failure path, so
    there it must simply drain completely);
  * with retries on, ≥ 99% of requests reach a terminal state within
    deadline (+ a one-tick grace: timeouts are detected on the step
    *after* the deadline passes);
  * goodput — useful completions (uncorrupted, accuracy > 0) inside the
    deadline per total Wh — strictly better with the reliability layer
    on than off;
  * the breaker demonstrably shifts routing share off the faulty arm
    mid-storm: it opens at least once, and the target's share of
    dispatch decisions inside the storm window drops versus baseline
    (the per-arm ``selections`` trajectory is the artifact CI keeps).

A fleet variant (on by default; ``--no-fleet`` skips it) wraps one
shard's engines in the same storm and kills a different shard mid-run:
responses + harvested failures must still cover every query
(``FleetController.failures``).

The routers run on ``device`` (None: the card; ``--device cpu`` for the
CPU) with featurize "auto".

    PYTHONPATH=src python -m repro_torch.benchmarks.chaos [--smoke]
"""
from __future__ import annotations

import argparse
from typing import Dict, List, Optional, Tuple

from repro_torch.benchmarks.common import (ClosedLoopResult,
                                           make_closed_loop_router,
                                           run_record, run_scenario,
                                           write_bench_artifact)
from repro_torch.data import OutcomeSimulator
from repro_torch.data.scenarios import Scenario, chaos
from repro_torch.serving import BreakerConfig

DEADLINE_S = 40.0        # modeled seconds, end-to-end over all attempts
MAX_RETRIES = 2
RETRY_BACKOFF_STEPS = 2
FRAC_START, FRAC_END = 0.35, 0.85   # storm window, fractions of arrivals
BREAKER = BreakerConfig(window=12, failure_threshold=0.5, min_samples=3,
                        open_steps=40, probe_quota=1, probe_successes=1)


def reliability_kwargs() -> dict:
    return {"deadline_s": DEADLINE_S, "max_retries": MAX_RETRIES,
            "retry_backoff_steps": RETRY_BACKOFF_STEPS,
            "breaker_config": BREAKER}


def run_chaos(per_task: int, seed: int, reliability: bool,
              targets: tuple, name: Optional[str] = None, device=None
              ) -> Tuple[ClosedLoopResult, Scenario]:
    scenario = chaos(per_task=per_task, seed=seed, targets=targets,
                     frac_start=FRAC_START, frac_end=FRAC_END)
    router = make_closed_loop_router(lam=0.4, seed=seed, device=device)
    res = run_scenario(
        scenario, router, seed=seed,
        outcome_fn=OutcomeSimulator(seed=seed + 7),
        # multi-tick requests + tight slots: faults land on in-flight
        # work and the virtual clock moves in small increments, so the
        # storm window spans many scheduler steps (breaker dynamics are
        # measured in steps)
        steps_per_query=3, concurrency=4,
        # cache off: the drill measures the routing/reliability path, so
        # every query must reach an engine (a semantic hit would also
        # happily replay a cached garbage completion)
        cache_mode="off",
        name=name or ("reliability" if reliability else "baseline"),
        # fine-grained samples: the storm-share metric differences the
        # cumulative per-arm selections across the storm window
        trace_every=5,
        server_kwargs=reliability_kwargs() if reliability else None)
    return res, scenario


def calibrate_targets(per_task: int, seed: int, n_targets: int = 2,
                      device=None) -> Tuple[tuple, "ClosedLoopResult"]:
    """Pick the storm's victims from a fault-free calibration drive: the
    ``n_targets`` arms with the most *energy at stake* inside the
    would-be storm window — dispatch decisions weighted by model size.
    A fixed target list goes stale (which arms the bandit leans on
    shifts with stream size and seed, and a storm aimed at an idle arm
    proves nothing), and raw traffic alone skews toward the cheapest
    arms, where masking detours the router *up* the cost curve and the
    reliability layer pays more than the storm costs.  Traffic × params
    lands the storm where the baseline burns the most replayed joules
    while the breaker's detour runs downhill."""
    res, scenario = run_chaos(per_task, seed, reliability=False,
                              targets=(), name="calibration", device=device)
    span = scenario.arrivals_s[-1]
    t0, t1 = span * FRAC_START, span * FRAC_END

    def counts_at(t_s: float) -> Dict[str, int]:
        best: Dict[str, int] = {}
        for s in res.trajectory:
            if s["t_s"] <= t_s:
                best = s["selections"]
        return best

    before, after = counts_at(t0), counts_at(t1)
    window = {n: after.get(n, 0) - before.get(n, 0) for n in after}
    params = {n: getattr(e.profile, "params_b", 1.0)
              for n, e in res.server.engines.items()}
    stake = {n: c * params.get(n, 1.0) for n, c in window.items() if c > 0}
    ranked = sorted(stake, key=lambda n: (-stake[n], n))
    return tuple(ranked[:n_targets]), res


# -- metrics -----------------------------------------------------------------


def goodput_per_wh(res: ClosedLoopResult, deadline_s: float) -> float:
    """Useful completions — uncorrupted, accuracy > 0, finished inside
    the deadline — per total Wh actually burned (failed attempts
    included via the engines' joule ledgers)."""
    useful = sum(
        1 for r in res.server.responses.values()
        if not getattr(r, "corrupt", False)
        and getattr(r, "accuracy", 0.0) > 0.0
        and r.latency_ms / 1e3 <= deadline_s)
    total_wh = sum(e.cumulative_joules()
                   for e in res.server.engines.values()) / 3600.0
    return useful / max(total_wh, 1e-9)


def terminal_within_deadline_frac(res: ClosedLoopResult,
                                  deadline_s: float,
                                  grace_s: float = 2.0) -> float:
    """Fraction of admitted requests that reached a terminal state
    (Response, TIMED_OUT, or FAILED) within deadline + grace.  Timeouts
    are detected on the scheduler step *after* the deadline passes, so
    the grace absorbs one virtual-clock tick."""
    n = ok = 0
    for r in res.server.responses.values():
        n += 1
        ok += r.latency_ms / 1e3 <= deadline_s + grace_s
    for req in res.server.failed.values():
        n += 1
        ok += (req.finish_s - req.submit_s) <= req.deadline_s + grace_s
    return ok / max(n, 1)


def storm_share(res: ClosedLoopResult, scenario: Scenario,
                targets: tuple) -> float:
    """The target arms' combined share of dispatch decisions made
    *inside* the storm window, read off the cumulative per-arm
    ``selections`` trajectory (difference of the samples bracketing the
    window)."""
    storm = [f for t in targets for f in scenario.faults[t]
             if f.kind == "garbage"]
    t0 = min(f.t_s for f in storm)
    t1 = max(f.t_s + f.duration_s for f in storm)

    def counts_at(t_s: float) -> Dict[str, int]:
        best: Dict[str, int] = {}
        for s in res.trajectory:
            if s["t_s"] <= t_s:
                best = s["selections"]
        return best

    before, after = counts_at(t0), counts_at(t1)
    window = {n: after.get(n, 0) - before.get(n, 0) for n in after}
    total = sum(window.values())
    return sum(window.get(t, 0) for t in targets) / max(total, 1)


def _assert_or_report(checks) -> List[str]:
    failures = [msg for ok, msg in checks if not ok]
    if failures:
        raise AssertionError("; ".join(failures))
    return [msg for _, msg in checks]


# -- fleet variant -----------------------------------------------------------


def run_fleet_chaos(n: int = 80, seed: int = 0, device=None) -> dict:
    """A 3-shard fleet where shard 0's engines ride the fault storm and
    shard 2 is killed mid-run — responses + harvested terminal failures
    must still cover every dispatched query."""
    from repro_torch.benchmarks.common import ENERGY_SCALE_WH
    from repro_torch.configs.pool import build_paper_pool
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.types import RouterConfig
    from repro_torch.data.scenarios import poisson_arrivals
    from repro_torch.data.stream import make_stream
    from repro_torch.device import resolve_device
    from repro_torch.fleet import (base_model_name, build_fleet,
                                   drive_fleet, plan_fleet)
    from repro_torch.serving import FaultInjector, SimEngine
    from repro_torch.serving.faults import fault_storm

    device = resolve_device(device)
    exclude = ["yi-34b", "gemma-3-27b", "qwen2.5-14b", "phi-4-14b",
               "gemma-3-12b", "llama-3.1-8b", "qwen2.5-7b", "mistral-7b"]
    target = "qwen2.5-3b"
    clk = {"t": 0.0}
    clock = lambda: clk["t"]  # noqa: E731
    sim = OutcomeSimulator(seed=seed + 3)
    outcome = lambda q, m: sim(q, base_model_name(m))  # noqa: E731
    pool_names = [p.name for p in build_paper_pool(exclude=exclude)]
    plan = plan_fleet(3, pool_names, devices=[device])
    queries = make_stream(per_task=max(1, n // 5), seed=seed)[:n]
    arrivals = poisson_arrivals(len(queries), 12.0, seed=seed + 1)
    faults = fault_storm(span_s=arrivals[-1], target=target,
                         others=[p for p in pool_names if p != target],
                         seed=seed + 2)
    storm_shard = plan.shards[0].name

    def router_factory(spec):
        cfg = RouterConfig(lam=0.4, seed=seed + spec.index,
                           energy_scale_wh=ENERGY_SCALE_WH, max_arms=24)
        return make_closed_loop_router(
            config=cfg, pool=ModelPool(build_paper_pool(exclude=exclude)),
            fit_classifier=False, device=device)

    def engine_factory(profile, spec):
        eng = SimEngine(profile, outcome, steps_per_query=2,
                        concurrency=4, clock=clock)
        base = base_model_name(profile.name)
        if spec.name == storm_shard and base in faults:
            return FaultInjector(eng, faults[base], clock=clock)
        return eng

    controller = build_fleet(
        plan, router_factory, engine_factory, sync_every=4,
        heartbeat_timeout_s=0.3, clock=clock,
        server_kwargs=reliability_kwargs())
    victim = plan.shards[-1].name
    t_kill = arrivals[int(0.4 * len(arrivals))]
    trajectory = drive_fleet(
        controller, queries, arrivals, clk,
        events=[(t_kill, lambda: controller.kill_shard(victim))])
    answered = len(controller.responses) + len(controller.failures)
    checks = [
        (answered == len(queries),
         f"fleet chaos lost requests: {len(controller.responses)} "
         f"responses + {len(controller.failures)} failures != "
         f"{len(queries)}"),
        (controller.stats["failovers"] >= 1,
         "shard kill never surfaced as a fail-over"),
    ]
    _assert_or_report(checks)
    return {"n_queries": len(queries),
            "completed": len(controller.responses),
            "failed": len(controller.failures),
            "span_s": round(clk["t"], 3), "stats": dict(controller.stats),
            "events": controller.events, "trajectory": trajectory}


# -- entry point -------------------------------------------------------------


def main(per_task: int = 60, seed: int = 0, smoke: bool = False,
         fleet: bool = True,
         artifact: Optional[str] = "BENCH_chaos.json",
         device=None) -> List[str]:
    if smoke:
        # below ~100 queries the bandit is still exploring and the storm
        # window holds too little traffic to measure anything
        per_task = min(per_task, 20)
    # A fault-free calibration pass picks the storm victims: the arms the
    # bandit actually leans on inside the would-be storm window at *this*
    # scale and seed.  Fixed targets can miss all in-window traffic.
    targets, _calib = calibrate_targets(per_task, seed, device=device)
    rel, scenario = run_chaos(per_task, seed, reliability=True,
                              targets=targets, device=device)
    base, _ = run_chaos(per_task, seed, reliability=False, targets=targets,
                        device=device)
    n = scenario.n_queries
    g_rel = goodput_per_wh(rel, DEADLINE_S)
    g_base = goodput_per_wh(base, DEADLINE_S)
    term_frac = terminal_within_deadline_frac(rel, DEADLINE_S)
    share_rel = storm_share(rel, scenario, targets)
    share_base = storm_share(base, scenario, targets)
    checks = [
        (rel.completed + rel.failed == n,
         f"reliability run lost requests: {rel.completed} responses + "
         f"{rel.failed} failures != {n}"),
        (base.completed == n,
         f"baseline lost requests: {base.completed}/{n}"),
        (term_frac >= 0.99,
         f"only {term_frac:.1%} of requests terminal within deadline"),
        (g_rel > g_base,
         f"goodput did not improve: {g_rel:.2f}/Wh (reliability) vs "
         f"{g_base:.2f}/Wh (baseline)"),
        (rel.stats["breaker_opens"] >= 1,
         "the storm never tripped a breaker"),
        (share_rel < share_base,
         f"breaker failed to shift routing share off {targets}: "
         f"{share_rel:.1%} (reliability) vs {share_base:.1%} (baseline) "
         "inside the storm window"),
        (rel.stats["retries"] >= 1, "the storm never triggered a retry"),
    ]
    _assert_or_report(checks)
    lines = ["run,completed,failed,accuracy,wh,goodput_per_wh,"
             "storm_share,retries,timeouts,breaker_opens"]
    for tag, res, g, share in (("reliability", rel, g_rel, share_rel),
                               ("baseline", base, g_base, share_base)):
        lines.append(
            f"{tag},{res.completed}/{n},{res.failed},"
            f"{res.mean_accuracy:.3f},{res.total_energy_wh:.2f},"
            f"{g:.2f},{share:.3f},{res.stats['retries']},"
            f"{res.stats['timeouts']},{res.stats['breaker_opens']}")
    runs = {"reliability": {**run_record(rel),
                            "storm_targets": list(targets)},
            "baseline": run_record(base)}
    if fleet:
        fleet_rec = run_fleet_chaos(n=24 if smoke else 80, seed=seed,
                                    device=device)
        runs["fleet"] = fleet_rec
        lines.append(
            f"fleet,{fleet_rec['completed']}/{fleet_rec['n_queries']},"
            f"{fleet_rec['failed']},,,,,"
            f"{fleet_rec['stats'].get('failovers', 0)} failovers,,")
    if artifact:
        write_bench_artifact(
            artifact, bench="chaos", seed=seed,
            headline={"goodput_reliability_per_wh": g_rel,
                      "goodput_baseline_per_wh": g_base,
                      "terminal_within_deadline_frac": term_frac,
                      "storm_share_reliability": share_rel,
                      "storm_share_baseline": share_base,
                      "breaker_opens": rel.stats["breaker_opens"],
                      "retries": rel.stats["retries"],
                      "timeouts": rel.stats["timeouts"]},
            runs=runs)
        lines.append(f"artifact,path,{artifact}")
    if smoke:
        lines.append("smoke,all chaos invariants hold")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-task", type=int, default=60,
                    help="stream queries per task family")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="scaled-down run; chaos invariants still "
                         "asserted")
    ap.add_argument("--no-fleet", action="store_true",
                    help="skip the fleet chaos variant")
    ap.add_argument("--artifact", default="BENCH_chaos.json",
                    help="artifact path ('' disables)")
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args()
    print("\n".join(main(per_task=args.per_task, seed=args.seed,
                         smoke=args.smoke, fleet=not args.no_fleet,
                         artifact=args.artifact or None,
                         device=args.device)))
