"""GreenCache's workload and drive: repeated-prefix + near-duplicate
traffic under Poisson arrivals on a virtual clock.

``make_workload`` is the JAX package's ``benchmarks/bench_cache.py``
workload, draw for draw: every query opens with one of three ~40-token
shared instruction preambles (prefix-KV reuse territory) plus an
~8-token tail, and ``repeat_frac`` of them are exact repeats of an
earlier query (semantic-cache territory).  ``drive`` serves it through a
built ``PoolServer`` as that module's ``drive`` does: each step the
arrivals that are due are admitted in one ``submit_batch``, the server
steps once and the virtual clock advances ``dt_s``; TTFT is counted in
scheduler steps (0 for a query answered from the cache).

``governed_telemetry`` builds that bench's governed telemetry: the
wall-clock governor (``horizon_s``) over the stream's span on the same
virtual clock, optionally with the diurnal carbon signal scaling its
refill over one simulated day.  A server built with it and driven here
credits every cache hit to the governor (prefix hits through the
engines' avoided-joule meters, semantic hits by the scheduler), and the
scorecard carries the governor's ledger and λ trace.

The rest is the JAX bench itself.  ``build_pool`` builds its engines
(smoke fp32 configs at ``max_seq_len`` 96, ``max_batch`` 4, ``max_len``
96, weights drawn from ``seed + i``, or the caller's built models), and
``drive_archs`` is its by-arch ``drive``: a fresh pool, router, cache
(128 KV blocks, semantic threshold 0.98) and telemetry per run, governed
when given a budget, the λ and joule trace of every step and the
reference's scorecard.  ``main`` runs every mode against ``off``, the
governor's ledger of the ``full`` run and the diurnal carbon pair
(``_half_day_stats``), with ``--smoke``'s assertions, the
``BENCH_cache.json`` artifact and the JSONL dump.  The engines and the
router run on ``device`` (None: the card).

    PYTHONPATH=src python -m repro_torch.benchmarks.cache [--smoke] \
        [--queries N] [--out f] [--artifact f] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import random
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.cache import GreenCache
from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Query, RouterConfig
from repro_torch.data import tokenizer as tok
from repro_torch.serving import ModelEngine, PoolServer
from repro_torch.telemetry import (EnergyBudgetGovernor, Telemetry,
                                   diurnal_carbon_intensity, dump_jsonl,
                                   to_prometheus)

MAX_LEN = 96             # the smoke engines' max_seq_len and max_len

# ~39 chars each => 40-token preambles after BOS (byte tokenizer); tails
# add ~8 tokens.  Shared preambles are the prefix-reuse surface.
PREAMBLES = [
    "Answer the exam question about topic x: ",
    "Summarize the committee filing on item ",
    "Solve the word problem with held value ",
]
TAILS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "theta",
         "kappa"]


def make_workload(n_queries: int, seed: int = 0, repeat_frac: float = 0.35,
                  mean_interarrival_s: float = 0.08
                  ) -> Tuple[List[Query], List[float]]:
    """(queries, arrival times): preamble+tail texts, ``repeat_frac`` of
    them exact repeats of an earlier query, Poisson (exponential
    inter-arrival) timestamps.  Fully seeded — replays identically."""
    rng = random.Random(seed)
    nrng = np.random.default_rng(seed)
    texts: List[str] = []
    for _ in range(n_queries):
        if texts and rng.random() < repeat_frac:
            texts.append(rng.choice(texts))          # near-duplicate traffic
        else:
            texts.append(rng.choice(PREAMBLES) + rng.choice(TAILS))
    arrivals = np.cumsum(nrng.exponential(mean_interarrival_s,
                                          size=n_queries))
    queries = [Query(uid=i, text=t, max_new_tokens=4)
               for i, t in enumerate(texts)]
    return queries, [float(a) for a in arrivals]


def governed_telemetry(budget_wh: Optional[float], arrivals: List[float],
                       clock: Dict[str, float],
                       carbon_amplitude: Optional[float] = None,
                       day_s: Optional[float] = None) -> Telemetry:
    """Telemetry on the virtual ``clock`` (``clock["t"]``, the time
    ``drive`` advances), governed when ``budget_wh`` is given: the
    wall-clock governor refills per virtual second against ``horizon_s``
    = the stream's span plus 5 s, or ``day_s``, one simulated day
    compressed onto the run.  With ``carbon_amplitude`` the refill is
    also scaled by the diurnal carbon signal over that day (the stream's
    span when ``day_s`` is None) — the dirty peak in its first half, the
    clean trough in its second."""
    horizon_s = day_s if day_s is not None else arrivals[-1] + 5.0
    period_s = day_s if day_s is not None else arrivals[-1]
    carbon_fn = None
    if carbon_amplitude is not None:
        carbon_fn = lambda t: diurnal_carbon_intensity(  # noqa: E731
            t, amplitude=carbon_amplitude, period_s=period_s)
    governor = (EnergyBudgetGovernor(budget_wh, horizon_s=horizon_s,
                                     carbon_fn=carbon_fn)
                if budget_wh else None)
    return Telemetry(governor=governor, clock=lambda: clock["t"])


def drive(server, queries: List[Query], arrivals: List[float],
          dt_s: float = 0.05, clock: Optional[Dict[str, float]] = None,
          on_step: Optional[Callable[[int], None]] = None) -> dict:
    """Serve the stream on a virtual clock through ``server``; returns
    the scorecard: the engines' metered joules and avoided joules, mean
    TTFT in scheduler steps, semantic and prefix hits, prefix tokens
    reused, completions, steps, admission batches and the responses'
    Wh.  The engines' ledgers are read as differences over the drive, so
    a server whose engines served before scores only this stream.
    ``clock`` is the virtual clock to advance (``{"t": 0.0}`` made here
    when None) — pass the one the server's telemetry and cache read.
    With a governor, the scorecard adds its ``stats()`` and the λ in
    force after each step (``lambda_trace``, (t, λ) pairs).  ``on_step(
    step)`` runs after each step, once the clock has advanced."""
    engines = list(server.engines.values())

    def ledgers():
        return (sum(e.cumulative_joules() for e in engines),
                sum(e.cumulative_joules_avoided() for e in engines),
                sum(e.prefix_hit_count() for e in engines))

    sem = server.cache.semantic if server.cache is not None else None
    telemetry = getattr(server, "telemetry", None)
    governor = telemetry.governor if telemetry is not None else None
    start = ledgers()
    sem_hits0 = sem.hits if sem is not None else 0
    clock = clock if clock is not None else {"t": 0.0}
    i, step = 0, 0
    lambda_trace: List[Tuple[float, float]] = []
    submit_step: Dict[int, int] = {}
    ttft_steps: Dict[int, int] = {}
    batches = 0
    reused = 0
    while i < len(queries) or server.inflight:
        due = []
        while i < len(queries) and arrivals[i] <= clock["t"]:
            due.append(queries[i])
            i += 1
        if due:
            batches += 1
            for q, req in zip(due, server.submit_batch(due)):
                if req.done:
                    ttft_steps[q.uid] = 0            # answered from cache
                else:
                    submit_step[q.uid] = step
        done = server.step()
        step += 1
        clock["t"] += dt_s
        if governor is not None:
            lambda_trace.append((clock["t"], governor.current_lambda))
        if on_step is not None:
            on_step(step)
        for uid, req in server.inflight.items():
            if req.generated and uid not in ttft_steps:
                ttft_steps[uid] = step - submit_step[uid]
        for resp in done:                            # completed same-step
            ttft_steps.setdefault(resp.uid, step - submit_step[resp.uid])
            reused += resp.prefix_reused
        if step > 100_000:
            raise TimeoutError("cache stream failed to drain")
    joules, avoided, prefix_hits = (b - a for a, b in zip(start, ledgers()))
    card = {
        "joules": joules,
        "avoided_joules": avoided,
        "ttft_steps_mean": float(np.mean([ttft_steps[q.uid]
                                          for q in queries])),
        "semantic_hits": (sem.hits - sem_hits0) if sem is not None else 0,
        "prefix_hits": prefix_hits,
        "prefix_tokens_reused": reused,
        "completed": len(server.responses),
        "steps": step,
        "admission_batches": batches,
        "response_wh": sum(r.energy_wh for r in server.responses.values()),
    }
    if governor is not None:
        card["governor"] = governor.stats()
        card["lambda_trace"] = lambda_trace
    return card


def build_pool(arch_ids: List[str], seed: int = 0, device=None,
               weights: Optional[Dict[str, tuple]] = None
               ) -> Tuple[Dict[str, ModelEngine], ModelPool]:
    """The JAX bench's ``_build_pool``: one engine per arch (smoke fp32
    config at ``max_seq_len`` 96, weights from ``seed + i``), ``max_batch``
    4, ``max_len`` 96, and the pool of their profiles.  ``weights`` maps
    an arch to a built model, a ``(model, cfg)`` pair: that arch's engine
    serves ``model`` at ``cfg`` (full width on the card; the JAX
    package's weights, carried by ``models/convert.py``, in the tests)."""
    weights = weights or {}
    engines: Dict[str, ModelEngine] = {}
    for i, arch in enumerate(arch_ids):
        if arch in weights:
            model, cfg = weights[arch]
        else:
            model, cfg = None, get_config(
                arch, smoke=True, vocab_size=tok.VOCAB_SIZE,
                dtype="float32", max_seq_len=MAX_LEN)
        engines[arch] = ModelEngine(arch, cfg, seed + i, max_batch=4,
                                    max_len=MAX_LEN, params=model,
                                    detokenize=tok.decode, device=device)
    return engines, ModelPool([e.profile for e in engines.values()])


def drive_archs(arch_ids: List[str], queries: List[Query],
                arrivals: List[float], cache_mode: str,
                budget_wh: Optional[float] = None, dt_s: float = 0.05,
                seed: int = 0, carbon_amplitude: Optional[float] = None,
                day_s: Optional[float] = None, device=None,
                weights: Optional[Dict[str, tuple]] = None) -> dict:
    """The JAX bench's ``drive``: serve the stream on a virtual clock over
    a fresh pool of ``arch_ids`` (``build_pool``); returns the mode's
    scorecard.

    With ``budget_wh`` the wall-clock governor runs against
    ``horizon_s`` = the stream's span — refill accrues per virtual
    second, so cache hits (bucket credit) and Poisson bursts (drain)
    exercise the token bucket as live serving would.  ``day_s``
    compresses one simulated day onto the run (it becomes the governor
    horizon); with ``carbon_amplitude`` the refill is additionally scaled
    by the diurnal carbon signal over that day — dirty peak in the first
    half, clean trough in the second — and the returned ``trace`` of
    (t, λ, joules) samples shows the deferred spend."""
    engines, pool = build_pool(arch_ids, seed, device=device,
                               weights=weights)
    router = GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05),
                             pool, device=device)
    clk = {"t": 0.0}
    telemetry = governed_telemetry(budget_wh, arrivals, clk,
                                   carbon_amplitude, day_s)
    governor = telemetry.governor
    day_s = day_s if day_s is not None else arrivals[-1]
    cache = GreenCache(mode=cache_mode, kv_cache_blocks=128,
                       semantic_threshold=0.98, clock=lambda: clk["t"])
    server = PoolServer(router, engines, tokenizer=tok.encode,
                        telemetry=telemetry, prefill_chunk=4, cache=cache)
    trace: List[Tuple[float, float, float]] = []   # (t, λ, cumulative J)
    traj: List[dict] = []       # BENCH_cache.json trajectory samples

    def sample(step: int) -> None:
        lam_now = (governor.current_lambda if governor is not None
                   else router.config.lam) or router.config.lam
        joules_now = sum(e.cumulative_joules() for e in engines.values())
        trace.append((clk["t"], lam_now, joules_now))
        if step % 8 == 0:
            traj.append({"t_s": round(clk["t"], 6),
                         "completed": len(server.responses),
                         "joules": round(joules_now, 6),
                         "inflight": len(server.inflight)
                         + len(server.arrivals)})

    card = drive(server, queries, arrivals, dt_s=dt_s, clock=clk,
                 on_step=sample)
    cs = cache.stats()
    return {
        "mode": cache_mode,
        "joules": card["joules"],
        "ttft_steps_mean": card["ttft_steps_mean"],
        "semantic_hits": cs.get("semantic", {}).get("hits", 0),
        "prefix_hits": card["prefix_hits"],
        "avoided_joules": telemetry._avoided_cum_joules,
        "completed": card["completed"],
        "steps": card["steps"],
        "telemetry": telemetry,
        "governor": governor,
        "cache_stats": cs,
        "trace": trace,
        "trajectory": traj,
        "day_s": day_s,
        # what the governor actually meters: per-completion response Wh
        "response_wh": card["response_wh"],
    }


def _half_day_stats(result: dict) -> Tuple[float, float, float]:
    """(dirty-half mean λ, clean-half mean λ, dirty-half joule fraction)
    from a governed run's trace over the simulated day (post-drain tail
    beyond the day is excluded)."""
    day = result["day_s"]
    half = day / 2.0
    trace = [s for s in result["trace"] if s[0] <= day]
    lam_dirty = [lam for t, lam, _ in trace if t <= half]
    lam_clean = [lam for t, lam, _ in trace if t > half]
    total_j = trace[-1][2] if trace else 0.0
    j_dirty = max((j for t, _, j in trace if t <= half), default=0.0)
    frac_dirty = j_dirty / max(total_j, 1e-12)
    return (float(np.mean(lam_dirty)) if lam_dirty else 0.0,
            float(np.mean(lam_clean)) if lam_clean else 0.0,
            frac_dirty)


def check_smoke(reduction: float, full: dict, governor_stats: dict,
                carbon: Tuple[float, float, float],
                blind: Tuple[float, float, float]) -> None:
    """``--smoke``'s assertions: the ``full`` mode cuts joules >= 30%,
    both hit kinds occur, both avoided-energy series are exported, the
    governor's ledger carries the cache's credit, and the carbon-aware
    run defers spend out of the dirty half against its blind twin."""
    (lam_dirty, lam_clean, frac_carbon), (b_lam_dirty, b_lam_clean,
                                          frac_blind) = carbon, blind
    if not reduction >= 0.30:
        raise AssertionError(f"cache joule reduction {reduction:.1%} < 30% "
                             f"on the repeated-prefix smoke workload")
    if not (full["prefix_hits"] > 0 and full["semantic_hits"] > 0):
        raise AssertionError(f"hits: prefix {full['prefix_hits']}, "
                             f"semantic {full['semantic_hits']}")
    prom = to_prometheus(full["telemetry"].registry)
    for kind in ("prefix", "semantic"):
        series = f'greenserv_energy_joules_avoided_total{{kind="{kind}"}}'
        if series not in prom:
            raise AssertionError(f"{series} missing from the export")
    if not (governor_stats["avoided_prefix_wh"]
            + governor_stats["avoided_semantic_wh"]) > 0.0:
        raise AssertionError("governor ledger missing cache credit")
    # deferral signature vs the carbon-blind twin: the dirty-grid half
    # must run a tighter λ (spend deferred out of it) and the clean half a
    # looser one (boosted refill spends the deferred headroom)
    if not lam_dirty > b_lam_dirty:
        raise AssertionError(f"carbon governor failed to tighten the dirty "
                             f"half (aware {lam_dirty:.3f} ≤ blind "
                             f"{b_lam_dirty:.3f})")
    if not lam_clean < b_lam_clean:
        raise AssertionError(f"carbon governor failed to relax the clean "
                             f"half (aware {lam_clean:.3f} ≥ blind "
                             f"{b_lam_clean:.3f})")
    if not frac_carbon <= frac_blind + 0.05:
        raise AssertionError(f"carbon-aware dirty-half spend "
                             f"{frac_carbon:.1%} exceeds carbon-blind "
                             f"{frac_blind:.1%}")


def main(n_queries: int = 120, arch_ids: Optional[List[str]] = None,
         smoke: bool = False, out: Optional[str] = None,
         seed: int = 0,
         artifact: Optional[str] = "BENCH_cache.json",
         device=None,
         weights: Optional[Dict[str, tuple]] = None) -> List[str]:
    """``weights`` maps an arch to a ``(model, cfg)`` pair its engine
    serves (``build_pool``; default: smoke weights drawn from ``seed``)."""
    arch_ids = arch_ids or (["granite-3-8b"] if smoke
                            else ["granite-3-8b", "qwen2-moe-a2.7b"])
    queries, arrivals = make_workload(n_queries, seed=seed)
    lines = ["mode,joules,reduction_vs_off,ttft_steps_mean,prefix_hits,"
             "semantic_hits,completed,steps"]
    run = dict(seed=seed, device=device, weights=weights)

    off = drive_archs(arch_ids, queries, arrivals, "off", **run)
    # the governed runs get a budget at the OFF run's spend over the same
    # wall window — caching should hold well under it, visibly relaxing λ
    budget_wh = off["joules"] / 3600.0
    results = {"off": off}
    modes = ["full"] if smoke else ["prefix", "semantic", "full"]
    for mode in modes:
        results[mode] = drive_archs(arch_ids, queries, arrivals, mode,
                                    budget_wh=budget_wh, **run)
    for mode, r in results.items():
        red = 1.0 - r["joules"] / max(off["joules"], 1e-12)
        lines.append(f"{mode},{r['joules']:.4e},{red:.1%},"
                     f"{r['ttft_steps_mean']:.1f},{r['prefix_hits']},"
                     f"{r['semantic_hits']},{r['completed']},{r['steps']}")

    full = results["full"]
    reduction = 1.0 - full["joules"] / max(off["joules"], 1e-12)
    gov = full["governor"]
    g = gov.stats() if gov else {}
    lines.append(f"governor,avoided_prefix_wh,"
                 f"{g.get('avoided_prefix_wh', 0.0):.3e}")
    lines.append(f"governor,avoided_semantic_wh,"
                 f"{g.get('avoided_semantic_wh', 0.0):.3e}")
    lines.append(f"governor,lambda_final,{g.get('lambda', 0.0):.3f}")
    lines.append(f"governor,pressure,{g.get('pressure', 0.0):.3f}")

    # -- diurnal carbon signal: defer spend across a simulated day ---------
    # clean-room comparison: no cache (its avoided-energy credits would
    # mask the refill signal), the simulated day = the uncached run's full
    # drain window (arrival burst in the morning, backlog through the
    # evening), and a near-edge budget (5% headroom over the Wh the
    # governor actually meters per completion) so the dirty-half refill
    # cut surfaces as λ pressure instead of vanishing into bucket slack
    drain_s = off["steps"] * 0.05
    tight_wh = off["response_wh"] * 1.05
    blind = drive_archs(arch_ids, queries, arrivals, "off",
                        budget_wh=tight_wh, day_s=drain_s, **run)
    carbon = drive_archs(arch_ids, queries, arrivals, "off",
                         budget_wh=tight_wh, carbon_amplitude=0.8,
                         day_s=drain_s, **run)
    aware_stats, blind_stats = _half_day_stats(carbon), _half_day_stats(blind)
    lines.append("carbon,run,lambda_dirty_mean,lambda_clean_mean,"
                 "dirty_joule_frac")
    for name, (lam_dirty, lam_clean, frac) in (("aware", aware_stats),
                                               ("blind", blind_stats)):
        lines.append(f"carbon,{name},{lam_dirty:.3f},{lam_clean:.3f},"
                     f"{frac:.1%}")
    if smoke:
        check_smoke(reduction, full, g, aware_stats, blind_stats)

    if artifact:
        # trajectory artifact (BENCH_disagg.json's schema) so perf/energy
        # regressions diff across commits
        runs_json = {
            mode: {"mode": mode,
                   "joules": r["joules"],
                   "ttft_steps_mean": r["ttft_steps_mean"],
                   "prefix_hits": int(r["prefix_hits"]),
                   "semantic_hits": int(r["semantic_hits"]),
                   "avoided_joules": r["avoided_joules"],
                   "completed": r["completed"],
                   "steps": r["steps"],
                   "response_wh": r["response_wh"],
                   "trajectory": r["trajectory"]}
            for mode, r in results.items()}
        with open(artifact, "w") as f:
            json.dump({"bench": "cache",
                       "n_queries": n_queries,
                       "seed": seed,
                       "headline": {"joule_reduction_full": reduction},
                       "runs": runs_json}, f, indent=1, sort_keys=True)
        lines.append(f"artifact,path,{artifact}")

    if out:
        tel = full["telemetry"]
        n = dump_jsonl(out, tel.registry, tel.power, tel.events,
                       meta={"n_queries": n_queries,
                             "archs": ",".join(arch_ids),
                             "off_joules": off["joules"],
                             "full_joules": full["joules"],
                             "reduction": reduction,
                             "budget_wh": budget_wh})
        lines.append(f"dump,rows,{n}")
        lines.append(f"dump,path,{out}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="one engine, small stream, hard asserts "
                         "(>=30%% joule reduction)")
    ap.add_argument("--queries", type=int, default=None)
    ap.add_argument("--out", default=None, help="JSONL metrics dump path")
    ap.add_argument("--artifact", default="BENCH_cache.json",
                    help="trajectory artifact path ('' disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the engines' and router's device (default: the "
                         "card)")
    args = ap.parse_args()
    n = args.queries or (36 if args.smoke else 120)
    print("\n".join(main(n_queries=n, smoke=args.smoke, out=args.out,
                         seed=args.seed, artifact=args.artifact or None,
                         device=args.device)))
