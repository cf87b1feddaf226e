"""Serving launcher: the GreenServ pool server over real models.

Builds a heterogeneous pool of small-but-real models (one per requested
arch family), the GreenServ router with all three context features, the
GreenCache reuse layer (``--cache-mode``, default prefix-KV reuse), the
energy cost model (``--cost-model``, on by default), telemetry with an
optional energy-budget governor (``--energy-budget-wh``), and the
continuous-batching scheduler; then drives a synthetic query stream
through it with hedging and fault injection available as flags.  The
flags and defaults are the JAX package's ``repro/launch/serve.py``, plus
``--device`` (the card unless ``cpu`` is asked for).  ``--disaggregate``
is accepted and refused by ``PoolServer``: the port has no decode twins
yet.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --queries 60 \\
        --pool granite-3-8b rwkv6-1.6b qwen2-moe-a2.7b --hedge 40 \\
        --prefill-chunk 8 --cache-mode full --semantic-threshold 0.92

``serve(args, engines, pool)`` is the part after the pool is built, so a
caller with engines of its own (full-width ones on the card) runs the
launcher's exact configuration over them.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.cache import CACHE_MODES, GreenCache
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Query, RouterConfig
from repro_torch.costmodel import EnergyCostModel
from repro_torch.data import stream as stream_lib
from repro_torch.data import tokenizer as tok
from repro_torch.serving import ModelEngine, PoolServer
from repro_torch.telemetry import EnergyBudgetGovernor, Telemetry, dump_jsonl

DEFAULT_POOL = ["granite-3-8b", "rwkv6-1.6b", "qwen2-moe-a2.7b"]


def build_real_pool(arch_ids: List[str], max_batch: int = 4,
                    max_len: int = 192, seed: int = 0,
                    prefill_chunk: int = 8, disaggregate: bool = False,
                    device=None):
    """Reduced-config (smoke) engines + matching pool profiles, on
    ``device`` (the card unless the caller names another).

    ``prefill_chunk`` (prompt tokens per engine prefill tick, default 8)
    cuts TTFT roughly by the chunk factor on attention-cached layouts;
    recurrent/ring layouts clamp to 1.  With ``disaggregate`` each member
    also gets a decode twin sharing the primary's params, as in the JAX
    package; ``PoolServer`` refuses twins until the port's disaggregation
    slice.  Returns ``(engines, pool, decode_engines)``."""
    engines: Dict[str, ModelEngine] = {}
    decode_engines: Dict[str, ModelEngine] = {}
    for i, arch in enumerate(arch_ids):
        cfg = get_config(arch, smoke=True, vocab_size=tok.VOCAB_SIZE,
                         max_seq_len=max_len)
        eng = ModelEngine(arch, cfg, seed=seed + i, max_batch=max_batch,
                          max_len=max_len, detokenize=tok.decode,
                          prefill_chunk=prefill_chunk, device=device)
        engines[arch] = eng
        if disaggregate:
            decode_engines[arch] = ModelEngine(
                arch, cfg, max_batch=max_batch, max_len=max_len,
                params=eng.params, detokenize=tok.decode,
                prefill_chunk=prefill_chunk, device=device)
    pool = ModelPool([e.profile for e in engines.values()])
    return engines, pool, decode_engines


def exact_match_accuracy(query: Query, resp) -> float:
    """EM against the stream's reference (the quality signal — untrained
    smoke models rarely match, which is itself informative: the router
    learns their true (low) quality online)."""
    if not query.reference:
        return 0.0
    return float(query.reference.strip().lower() in resp.text.strip().lower())


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pool", nargs="+", default=DEFAULT_POOL,
                    choices=ARCH_IDS)
    ap.add_argument("--queries", type=int, default=40)
    ap.add_argument("--lam", type=float, default=0.4)
    ap.add_argument("--hedge", type=int, default=None,
                    help="hedge after N scheduler steps in queue")
    ap.add_argument("--fail-engine", default=None,
                    help="inject a failure into this engine mid-run")
    ap.add_argument("--energy-budget-wh", type=float, default=None,
                    help="cumulative Wh cap for the run; the governor "
                         "tightens λ online to stay under it")
    ap.add_argument("--metrics-out", default=None,
                    help="write the JSONL telemetry dump to this path")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens consumed per engine prefill tick "
                         "(1 = token-wise path; TTFT drops roughly by this "
                         "factor on attention-cached layouts)")
    ap.add_argument("--cache-mode", default="prefix", choices=CACHE_MODES,
                    help="GreenCache layers: prefix (launcher default — "
                         "cross-query prompt-KV reuse), semantic "
                         "(near-duplicate response cache), full (both), "
                         "off")
    ap.add_argument("--kv-cache-blocks", type=int, default=512,
                    help="per-engine prefix-KV pool capacity in blocks "
                         "(8 tokens each, host memory; LRU-evicted)")
    ap.add_argument("--semantic-threshold", type=float, default=0.92,
                    help="cosine similarity floor for a semantic response "
                         "cache hit (task-type/cluster guards always "
                         "apply)")
    ap.add_argument("--semantic-ttl", type=float, default=None,
                    help="max age in seconds for semantic response-cache "
                         "entries; older answers age out (default: no "
                         "staleness bound)")
    ap.add_argument("--featurize", default="auto",
                    choices=["auto", "host", "device"],
                    help="featurization placement: device = the featurize "
                         "and LinUCB kernels on the card, host = the numpy "
                         "path, auto = device when the router is on CUDA")
    ap.add_argument("--cost-model", default="on", choices=["on", "off"],
                    help="predictive energy cost model: pre-dispatch Wh "
                         "forecasts tilt routing, charge the governor's "
                         "in-flight budget, and calibrate online from the "
                         "metered joule ledger")
    ap.add_argument("--admission-planner", action="store_true",
                    help="energy-aware admission: defer arrivals whose "
                         "predicted Wh would breach the governor's "
                         "remaining budget this tick (needs --cost-model "
                         "on and --energy-budget-wh)")
    ap.add_argument("--disaggregate", action="store_true",
                    help="role-specialized serving (decode twins); the "
                         "port refuses it until its disaggregation slice")
    ap.add_argument("--device", default=None,
                    help="where the models and the router run (default: "
                         "the CUDA card; 'cpu' runs the plain versions)")
    return ap


def serve(args: argparse.Namespace, engines: Dict[str, ModelEngine],
          pool: ModelPool,
          decode_engines: Optional[Dict[str, ModelEngine]] = None) -> dict:
    """Route and serve ``args.queries`` stream queries through
    ``engines`` with the launcher's router, cache, cost model, telemetry
    and governor; prints the run's report and returns its parts
    (``server``, ``router``, ``cache``, ``cost_model``, ``telemetry``,
    ``governor``, ``queries``, ``wall_s``)."""
    config = RouterConfig(lam=args.lam, energy_scale_wh=0.05,
                          featurize=args.featurize)
    router = GreenServRouter(config, pool, device=args.device)
    queries = stream_lib.make_stream(per_task=max(args.queries // 5, 1))
    queries = queries[: args.queries]
    governor = None
    if args.energy_budget_wh is not None:
        governor = EnergyBudgetGovernor(args.energy_budget_wh,
                                        horizon_queries=len(queries))
    telemetry = Telemetry(governor=governor)
    cache = GreenCache(mode=args.cache_mode,
                       kv_cache_blocks=args.kv_cache_blocks,
                       semantic_threshold=args.semantic_threshold,
                       semantic_ttl_s=args.semantic_ttl)
    cost_model = (EnergyCostModel() if args.cost_model == "on" else None)
    server = PoolServer(router, engines, tokenizer=tok.encode,
                        hedge_after_steps=args.hedge,
                        accuracy_fn=exact_match_accuracy,
                        telemetry=telemetry,
                        prefill_chunk=args.prefill_chunk,
                        cache=cache,
                        decode_engines=decode_engines or None,
                        cost_model=cost_model,
                        admission_planner=args.admission_planner)
    t0 = time.monotonic()
    # continuous-batching drive: arrivals park in the scheduler's queue and
    # are admitted into free prefill slots each tick (routing happens at
    # admission, so the bandit sees the live queue state)
    for i, q in enumerate(queries):
        server.enqueue(q)
        if args.fail_engine and i == len(queries) // 2:
            engines[args.fail_engine].inject_failure()
        server.step()
    server.run_until_drained()
    wall = time.monotonic() - t0

    counts = router.selection_counts()
    print(f"[serve] {len(server.responses)}/{len(queries)} queries in "
          f"{wall:.1f}s; restarts={server.stats['restarts']} "
          f"hedges={server.stats['hedges']}")
    for name, c in zip(pool.names, counts):
        print(f"  {name:20s} selected {int(c):4d}×")
    total_wh = sum(r.energy_wh for r in server.responses.values())
    print(f"  total modeled energy: {total_wh:.4f} Wh; mean routing "
          f"overhead {router.mean_decision_ms:.2f} ms/query")
    if args.cache_mode != "off":
        cs = cache.stats()
        sem = cs.get("semantic", {})
        pre = cs.get("prefix", {})
        hit_tokens = sum(p["hit_tokens"] for p in pre.values())
        blocks = sum(p["blocks"] for p in pre.values())
        print(f"  cache[{args.cache_mode}]: semantic hits "
              f"{sem.get('hits', 0)}/{sem.get('lookups', 0)}; prefix hit "
              f"tokens {hit_tokens}; {blocks} KV blocks resident "
              f"({server.stats['cache_hits']} short-circuits)")
    if cost_model is not None:
        cm = cost_model.stats()
        print(f"  cost model: {cm['n_reconciled']}/{cm['n_predicted']} "
              f"forecasts reconciled; MAE {cm['mae_ratio']:.1%} of metered "
              f"Wh; deferred admissions {server.stats['deferred']}")
    print(telemetry.summary())
    if args.metrics_out:
        n = dump_jsonl(args.metrics_out, telemetry.registry, telemetry.power,
                       telemetry.events,
                       meta={"queries": len(queries), "wall_s": wall,
                             "lam": args.lam,
                             "budget_wh": args.energy_budget_wh})
        print(f"[serve] wrote {n} telemetry rows to {args.metrics_out}")
    return {"server": server, "router": router, "cache": cache,
            "cost_model": cost_model, "telemetry": telemetry,
            "governor": governor, "queries": queries, "wall_s": wall}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = build_parser().parse_args(argv)
    engines, pool, decode_engines = build_real_pool(
        args.pool, prefill_chunk=args.prefill_chunk,
        disaggregate=args.disaggregate, device=args.device)
    return serve(args, engines, pool, decode_engines)


if __name__ == "__main__":
    main()
