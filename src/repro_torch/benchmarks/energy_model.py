"""Predictive energy cost model validation: the forecast against the
metered ledger.

**Calibration accuracy.**  For each architecture class — dense
(granite-3-8b), MoE (qwen2-moe-a2.7b), encoder-decoder (whisper-medium) —
and each serving shape (a unified engine with chunked prefill; a
disaggregated prefill engine + decode twin with KV migration), a seeded
query stream is served with the ``EnergyCostModel`` in the loop.  A
warm-up slice calibrates the per-(engine, phase) RLS residuals and the
decode-length EWMA; then the error counters reset and the measurement
slice scores the mean absolute prediction error against the engines'
metered joule ledger.  ``--smoke`` asserts MAE < 10% of the metered Wh in
every (arch, shape) cell.

**Routing non-regression.**  A 4-arm ``SimEngine`` pool serves one seeded
stream twice — cost model off (the bandit's learned energy alone) and on
(the per-(query, arm) predicted-Wh tilt); ``--smoke`` asserts accuracy
holds within 0.02 and cumulative Wh within 2%.

Writes ``BENCH_energy.json`` (the JAX package's ``bench_energy_model``
schema, through ``common.write_bench_artifact``) and optionally an
``--out`` JSONL of per-cell metrics.  The engines (smoke fp32, weights
from ``seed`` unless the caller passes ``weights``) and the routers run
on ``device`` (None: the card; ``--device cpu`` for the CPU).

    PYTHONPATH=src python -m repro_torch.benchmarks.energy_model [--smoke] \
        [--queries 48] [--artifact BENCH_energy.json] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import random
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.benchmarks.common import write_bench_artifact
from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import ModelProfile, Query, RouterConfig
from repro_torch.costmodel import EnergyCostModel
from repro_torch.data import tokenizer as tok
from repro_torch.serving import ModelEngine, PoolServer, SimEngine

MAX_LEN = 96
ARCHS = ["granite-3-8b", "qwen2-moe-a2.7b", "whisper-medium"]
MAE_GATE = 0.10          # the acceptance bar: MAE < 10% of metered Wh

_TOPICS = ["billing", "retrieval", "summaries", "translation", "triage",
           "planning", "extraction", "synthesis"]


def cell_config(arch: str):
    """The smoke fp32 config every cell serves."""
    return get_config(arch, smoke=True, vocab_size=tok.VOCAB_SIZE,
                      dtype="float32", max_seq_len=MAX_LEN)


def make_workload(n_queries: int, seed: int = 0) -> List[Query]:
    """Seeded stream with varied prompt lengths and generation budgets —
    the shape diversity the forecaster has to cover."""
    rng = random.Random(seed)
    queries: List[Query] = []
    for i in range(n_queries):
        topic = rng.choice(_TOPICS)
        if rng.random() < 0.4:
            text = (f"user {i} forwards the {topic} thread: "
                    + "ctx " * rng.randint(4, 9))
        else:
            text = f"user {i} asks about {topic}"
        queries.append(Query(uid=i, text=text,
                             max_new_tokens=rng.randint(4, 10)))
    return queries


# -- part 1: calibration accuracy per (arch, serving shape) -----------------

def drive_cell(arch: str, disaggregate: bool, n_warmup: int, n_measure: int,
               seed: int = 0, prefill_chunk: int = 8,
               trace_every: int = 16, device=None, params=None) -> dict:
    """One (arch, shape) cell: serve the warm-up then the measurement
    slice on a one-member pool with the cost model reconciling every
    completion; MAE is scored on the measurement slice only."""
    cfg = cell_config(arch)
    kw = dict(max_batch=2, max_len=MAX_LEN, prefill_chunk=prefill_chunk,
              device=device)
    eng = ModelEngine(arch, cfg, seed, params=params, **kw)
    engines, decode_engines = {arch: eng}, None
    all_engines = [eng]
    if disaggregate:
        twin = ModelEngine(arch, cfg, seed, params=eng.params, role="decode",
                           **kw)
        decode_engines = {arch: twin}
        all_engines = [eng, twin]
    router = GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05),
                             ModelPool([eng.profile]), device=device)
    cm = EnergyCostModel()
    server = PoolServer(router, engines, tokenizer=tok.encode,
                        prefill_chunk=prefill_chunk,
                        decode_engines=decode_engines, cost_model=cm)
    stream = make_workload(n_warmup + n_measure, seed=seed)
    server.enqueue_many(stream[:n_warmup])
    server.run_until_drained()
    # the warm-up calibrated the residuals and the EWMA; score only fresh
    # forecasts
    cm.abs_err_wh = 0.0
    cm.measured_wh_sum = 0.0
    cm.history.clear()
    server.enqueue_many(stream[n_warmup:])
    traj: List[dict] = []
    step = 0
    while server.inflight or server.arrivals:
        server.step()
        step += 1
        if step % trace_every == 0:
            traj.append({
                "t_s": round(max(e.modeled_time_s()
                                 for e in all_engines), 9),
                "completed": len(server.responses),
                "joules": round(sum(e.cumulative_joules()
                                    for e in all_engines), 6),
                "inflight": len(server.inflight) + len(server.arrivals),
                "mae_ratio": round(cm.mae_ratio(), 6)})
        if step > 500_000:
            raise TimeoutError(f"{arch} cell failed to drain")
    return {
        "arch": arch,
        "mode": "disaggregated" if disaggregate else "unified",
        "completed": len(server.responses),
        "n_measured": cm.n_reconciled - n_warmup,
        "mae_ratio": cm.mae_ratio(),
        "mae_by_engine": cm.mae_ratio_by_engine(),
        "migrations": server.stats["migrations"],
        "joules": sum(e.cumulative_joules() for e in all_engines),
        "out_ratio": cm.engines[arch].out_ratio,
        "trajectory": traj,
    }


# -- part 2: routing non-regression (cost model on vs off) ------------------

def _sim_outcome(query: Query, model: str) -> Tuple[float, float, float, int]:
    """Bigger arms: higher accuracy, more Wh; per-query jitter from the
    uid, so any metric delta is a routing-decision delta."""
    i = int(model[3:])
    h = (query.uid * 2654435761 + i * 40503) % 1000 / 1000.0
    acc = min(0.55 + 0.1 * i + 0.1 * h, 1.0)
    wh = 0.002 * (i + 1) * (0.8 + 0.4 * h)
    return acc, wh, 10.0, 4


def drive_sim_pool(n_queries: int, cost_model_on: bool, seed: int = 0,
                   device=None) -> dict:
    """The same seeded stream through a 4-arm ``SimEngine`` pool: mean
    accuracy and cumulative Wh."""
    profiles = [ModelProfile(name=f"sim{i}", family="s", params_b=i + 1.0)
                for i in range(4)]
    router = GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.01,
                                          max_arms=16, seed=seed),
                             ModelPool(profiles), device=device)
    engines = {p.name: SimEngine(p, _sim_outcome) for p in profiles}
    cm = EnergyCostModel() if cost_model_on else None
    server = PoolServer(router, engines, cost_model=cm)
    stream = make_workload(n_queries, seed=seed + 1)
    server.enqueue_many(stream)
    server.run_until_drained()
    total_wh = sum(r.energy_wh for r in server.responses.values())
    acc_mean = float(np.mean([
        _sim_outcome(q, server.responses[q.uid].model_name)[0]
        for q in stream]))
    return {
        "mode": "cost_model_on" if cost_model_on else "cost_model_off",
        "completed": len(server.responses),
        "accuracy_mean": acc_mean,
        "total_wh": total_wh,
        "mae_ratio": cm.mae_ratio() if cm is not None else None,
        "selection_counts": [int(c) for c in router.selection_counts()],
    }


def main(n_queries: int = 48, smoke: bool = False,
         out: Optional[str] = None,
         artifact: Optional[str] = "BENCH_energy.json",
         seed: int = 0, device=None,
         weights: Optional[Dict[str, object]] = None) -> List[str]:
    """``weights`` maps an arch to the model its cells serve (default:
    weights drawn from ``seed``)."""
    weights = weights or {}
    n_warmup = max(n_queries // 3, 8)
    n_measure = n_queries - n_warmup
    lines = ["arch,mode,mae_ratio,n_measured,migrations,out_ratio"]
    runs: Dict[str, dict] = {}
    maes: Dict[str, float] = {}
    for arch in ARCHS:
        for disagg in (False, True):
            cell = drive_cell(arch, disagg, n_warmup, n_measure, seed=seed,
                              device=device, params=weights.get(arch))
            key = f"{arch}:{cell['mode']}"
            runs[key] = cell
            maes[key] = cell["mae_ratio"]
            lines.append(f"{arch},{cell['mode']},{cell['mae_ratio']:.4f},"
                         f"{cell['n_measured']},{cell['migrations']},"
                         f"{cell['out_ratio']:.3f}")

    n_sim = max(n_queries * 4, 160)
    off = drive_sim_pool(n_sim, cost_model_on=False, seed=seed, device=device)
    on = drive_sim_pool(n_sim, cost_model_on=True, seed=seed, device=device)
    acc_delta = on["accuracy_mean"] - off["accuracy_mean"]
    wh_ratio = on["total_wh"] / max(off["total_wh"], 1e-12)
    runs["sim:cost_model_off"] = off
    runs["sim:cost_model_on"] = on
    lines.append(f"sim,off,acc={off['accuracy_mean']:.4f},"
                 f"wh={off['total_wh']:.4e}")
    lines.append(f"sim,on,acc={on['accuracy_mean']:.4f},"
                 f"wh={on['total_wh']:.4e},mae={on['mae_ratio']:.4f}")
    lines.append(f"headline,mae_max,{max(maes.values()):.4f}")
    lines.append(f"headline,acc_delta,{acc_delta:+.4f}")
    lines.append(f"headline,joules_ratio_on_vs_off,{wh_ratio:.4f}")

    if artifact:
        write_bench_artifact(
            artifact, "energy_model", seed,
            {"mae_max": max(maes.values()), "mae_by_cell": maes,
             "acc_delta_on_vs_off": acc_delta,
             "joules_ratio_on_vs_off": wh_ratio},
            runs, n_queries=n_queries)
        lines.append(f"artifact,path,{artifact}")
    if out:
        with open(out, "w") as f:
            for key, r in runs.items():
                row = {k: v for k, v in r.items() if k != "trajectory"}
                row["cell"] = key
                f.write(json.dumps(row, sort_keys=True) + "\n")
        lines.append(f"dump,path,{out}")

    if smoke:
        for key, mae in maes.items():
            assert mae < MAE_GATE, (
                f"cost-model MAE {mae:.1%} >= {MAE_GATE:.0%} of metered Wh "
                f"on {key}")
        for key, cell in runs.items():
            if key.startswith(tuple(ARCHS)):
                assert cell["n_measured"] > 0, f"{key} measured nothing"
        assert any(r["migrations"] > 0 for k, r in runs.items()
                   if k.endswith(":disaggregated")), (
            "no disaggregated cell migrated KV — the migration prior was "
            "never exercised")
        # routing non-regression: the tilt must not trade accuracy away,
        # and cumulative energy must improve or hold within tolerance
        assert on["completed"] == off["completed"] == n_sim
        assert acc_delta >= -0.02, (
            f"cost-model tilt cost {-acc_delta:.1%} accuracy")
        assert wh_ratio <= 1.02, (
            f"cost-model tilt raised cumulative Wh by {wh_ratio - 1:.1%}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="hard asserts (MAE < 10% per cell; sim-pool "
                         "accuracy/energy hold)")
    ap.add_argument("--queries", type=int, default=None,
                    help="queries per (arch, shape) cell (default 120, "
                         "smoke 48)")
    ap.add_argument("--out", default=None,
                    help="per-cell JSONL metrics dump path")
    ap.add_argument("--artifact", default="BENCH_energy.json",
                    help="trajectory artifact path ('' disables)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the engines' and routers' device (default: the "
                         "card)")
    args = ap.parse_args()
    n = args.queries or (48 if args.smoke else 120)
    print("\n".join(main(n_queries=n, smoke=args.smoke, out=args.out,
                         artifact=args.artifact or None, seed=args.seed,
                         device=args.device)))
