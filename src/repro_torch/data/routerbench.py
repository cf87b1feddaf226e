"""RouterBench-style offline evaluation (paper §6.3.6, Table 1).

RouterBench distributes a pre-computed (query × model) matrix of accuracy
and cost — routers are evaluated offline by lookup, no inference.  The real
matrices aren't redistributable, so we synthesize matrices with the
same structure: 9 task families × 11 router-pool models, per-(task, model)
mean accuracies in the public benchmark's range (best single model ≈ 0.75,
worst ≈ 0.35), per-query Bernoulli draws, and per-1k-token cost proxies.

AIQ (Average Improvement in Quality) follows the benchmark's definition:
the area under the non-decreasing quality-vs-cost envelope swept by the
willingness-to-pay parameter, normalized by the cost span.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

RB_TASKS = ["mmlu", "hellaswag", "winogrande", "gsm8k", "arc", "mbpp",
            "mtbench", "rag", "commonsense"]

# (mean accuracy per task row below, cost $/1k tokens)
RB_MODELS: Dict[str, Tuple[float, float]] = {
    "rb-frontier-a": (0.78, 30.0),    # gpt-4-class
    "rb-frontier-b": (0.74, 24.0),
    "rb-mid-a": (0.70, 8.0),
    "rb-mid-b": (0.68, 6.0),
    "rb-mid-c": (0.64, 3.0),
    "rb-open-13b": (0.58, 1.2),
    "rb-open-7b-a": (0.52, 0.6),
    "rb-open-7b-b": (0.50, 0.6),
    "rb-small-a": (0.44, 0.3),
    "rb-small-b": (0.40, 0.25),
    "rb-tiny": (0.33, 0.1),
}


@dataclasses.dataclass
class RouterBenchTable:
    tasks: List[str]
    models: List[str]
    accuracy: np.ndarray        # (Q, M) binary outcomes
    cost: np.ndarray            # (Q, M) $ per query
    task_of: np.ndarray         # (Q,) task index
    mean_acc: np.ndarray        # (T, M) the latent means

    @property
    def n_queries(self) -> int:
        return self.accuracy.shape[0]


def build_table(n_per_task: int = 400, seed: int = 0) -> RouterBenchTable:
    rng = np.random.default_rng(seed)
    models = list(RB_MODELS)
    t, m = len(RB_TASKS), len(models)
    base = np.array([RB_MODELS[name][0] for name in models])
    # per-task specialization: ±0.08, deterministic per (task, model)
    spec = rng.uniform(-0.08, 0.08, size=(t, m))
    mean_acc = np.clip(base[None, :] + spec, 0.05, 0.95)
    cost_1k = np.array([RB_MODELS[name][1] for name in models])
    tokens_per_query = rng.uniform(0.4, 2.0, size=(t,))   # k-tokens per task

    q = n_per_task * t
    task_of = np.repeat(np.arange(t), n_per_task)
    rng.shuffle(task_of)
    acc = (rng.random((q, m)) < mean_acc[task_of]).astype(np.float64)
    cost = (cost_1k[None, :] * tokens_per_query[task_of][:, None]
            * rng.uniform(0.8, 1.25, size=(q, m)))
    return RouterBenchTable(tasks=list(RB_TASKS), models=models,
                            accuracy=acc, cost=cost, task_of=task_of,
                            mean_acc=mean_acc)


def query_text(table: RouterBenchTable, i: int) -> str:
    """Synthetic text whose instruction line identifies the task family —
    the same signal the real benchmark's prompts carry."""
    t = table.tasks[table.task_of[i]]
    return (f"Complete the {t} benchmark item.\n"
            f"Task {t} instance {i}: choose or produce the correct answer.")


def aiq(points: Sequence[Tuple[float, float]]) -> float:
    """Area under the non-decreasing quality/cost envelope, cost-normalized.

    ``points``: (mean_cost, mean_quality) per willingness-to-pay setting.
    """
    pts = sorted(points)
    if len(pts) < 2:
        return 0.0
    costs = np.array([p[0] for p in pts])
    quals = np.maximum.accumulate(np.array([p[1] for p in pts]))
    span = costs[-1] - costs[0]
    if span <= 0:
        return float(quals.max())
    area = np.trapezoid(quals, costs)
    return float(area / span)
