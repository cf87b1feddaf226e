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
scheduler steps (0 for a query answered from the cache).  The
governor and telemetry parts of the JAX bench wait for the port's
telemetry slice.
"""
from __future__ import annotations

import random
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.types import Query

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


def drive(server, queries: List[Query], arrivals: List[float],
          dt_s: float = 0.05) -> dict:
    """Serve the stream on a virtual clock through ``server``; returns
    the scorecard: the engines' metered joules and avoided joules, mean
    TTFT in scheduler steps, semantic and prefix hits, prefix tokens
    reused, completions, steps and admission batches.  The engines'
    ledgers are read as differences over the drive, so a server whose
    engines served before scores only this stream."""
    engines = list(server.engines.values())

    def ledgers():
        return (sum(e.cumulative_joules() for e in engines),
                sum(e.cumulative_joules_avoided() for e in engines),
                sum(e.prefix_hit_count() for e in engines))

    sem = server.cache.semantic if server.cache is not None else None
    start = ledgers()
    sem_hits0 = sem.hits if sem is not None else 0
    clock, i, step = 0.0, 0, 0
    submit_step: Dict[int, int] = {}
    ttft_steps: Dict[int, int] = {}
    batches = 0
    reused = 0
    while i < len(queries) or server.inflight:
        due = []
        while i < len(queries) and arrivals[i] <= clock:
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
        clock += dt_s
        for uid, req in server.inflight.items():
            if req.generated and uid not in ttft_steps:
                ttft_steps[uid] = step - submit_step[uid]
        for resp in done:                            # completed same-step
            ttft_steps.setdefault(resp.uid, step - submit_step[resp.uid])
            reused += resp.prefix_reused
        if step > 100_000:
            raise TimeoutError("cache stream failed to drain")
    joules, avoided, prefix_hits = (b - a for a, b in zip(start, ledgers()))
    return {
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
    }
