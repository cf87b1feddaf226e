"""Per-(model, task) behaviour tables calibrated to the paper's aggregates.

The paper measures 16 open-weight models on 5 benchmarks with an A100 power
meter; this repository has neither the weights nor the meter, so the decision
problem is reproduced from calibrated tables: mean normalized accuracy per
(model, task) and an analytic energy model per query.  Calibration targets
(paper §6.3, Fig. 2–3): random ≈ 0.51 acc / ~96 mWh/query; smallest
(qwen-0.5b) ≈ 0.33; largest (yi-34b) ≈ 0.39; best (gemma-3-27b) ≈ 0.74 at
the highest energy; GreenServ at λ=0.4 reaches ≈ 0.65 at ~66 mWh/query.
``tests/test_paper_claims.py`` asserts these aggregates (and
``tests/test_torch_paper_claims.py`` on this package).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.types import Query, TaskType

# --- mean normalized accuracy per (model, task) ------------------------------
# columns: QA(mmlu)  COMPLETION(hellaswag)  REASONING(winogrande)  MATH(gsm8k)
#          SUMMARIZATION(cnn/dm rouge, min-max normalized)
ACCURACY: Dict[str, Tuple[float, float, float, float, float]] = {
    "qwen2.5-0.5b":  (0.28, 0.36, 0.48, 0.12, 0.40),
    "qwen2.5-1.5b":  (0.35, 0.42, 0.52, 0.22, 0.42),
    "qwen2.5-3b":    (0.45, 0.52, 0.58, 0.38, 0.48),
    "qwen2.5-7b":    (0.55, 0.62, 0.64, 0.52, 0.55),
    "qwen2.5-14b":   (0.63, 0.70, 0.70, 0.64, 0.60),
    "mistral-7b":    (0.50, 0.60, 0.62, 0.40, 0.55),
    "gemma-3-1b":    (0.30, 0.38, 0.48, 0.18, 0.45),
    "gemma-3-4b":    (0.52, 0.58, 0.62, 0.46, 0.58),
    "gemma-3-12b":   (0.66, 0.72, 0.72, 0.66, 0.66),
    "gemma-3-27b":   (0.74, 0.78, 0.76, 0.74, 0.70),
    "llama-3.1-1b":  (0.28, 0.36, 0.46, 0.14, 0.40),
    "llama-3.2-3b":  (0.46, 0.54, 0.60, 0.40, 0.52),
    "llama-3.1-8b":  (0.58, 0.66, 0.68, 0.56, 0.60),
    "phi-4-mini-4b": (0.56, 0.60, 0.62, 0.60, 0.50),
    "phi-4-14b":     (0.68, 0.70, 0.70, 0.72, 0.58),
    "yi-34b":        (0.36, 0.44, 0.50, 0.22, 0.42),
}

PARAMS_B: Dict[str, float] = {
    "qwen2.5-0.5b": 0.5, "qwen2.5-1.5b": 1.5, "qwen2.5-3b": 3.0,
    "qwen2.5-7b": 7.0, "qwen2.5-14b": 14.0, "mistral-7b": 7.0,
    "gemma-3-1b": 1.0, "gemma-3-4b": 4.0, "gemma-3-12b": 12.0,
    "gemma-3-27b": 27.0, "llama-3.1-1b": 1.0, "llama-3.2-3b": 3.0,
    "llama-3.1-8b": 8.0, "phi-4-mini-4b": 4.0, "phi-4-14b": 14.0,
    "yi-34b": 34.0,
}

# per-model energy multiplier (gemma's 262k-vocab head and long outputs make
# it the most expensive family in the paper's Table 3; yi is comparatively
# efficient per parameter)
ENERGY_MULT: Dict[str, float] = {
    "gemma-3-1b": 1.35, "gemma-3-4b": 1.35, "gemma-3-12b": 1.35,
    "gemma-3-27b": 1.33, "yi-34b": 0.68,
}

# (input_tokens, output_tokens) per task family
TASK_TOKENS: Dict[TaskType, Tuple[int, int]] = {
    TaskType.QA: (256, 8),
    TaskType.COMPLETION: (128, 8),
    TaskType.REASONING: (64, 4),
    TaskType.MATH: (128, 96),
    TaskType.SUMMARIZATION: (1024, 128),
}

MWH_PER_B_PER_OUT_TOKEN = 0.15
MWH_PER_B_PER_IN_TOKEN = 0.002
MWH_FIXED_OVERHEAD = 8.0


def mean_energy_mwh(model: str, task: TaskType) -> float:
    p = PARAMS_B[model]
    tin, tout = TASK_TOKENS[task]
    e = (MWH_FIXED_OVERHEAD + p * tout * MWH_PER_B_PER_OUT_TOKEN +
         p * tin * MWH_PER_B_PER_IN_TOKEN)
    return e * ENERGY_MULT.get(model, 1.0)


def mean_accuracy(model: str, task: TaskType) -> float:
    return ACCURACY[model][int(task)]


class OutcomeSimulator:
    """Stochastic per-query outcomes: Bernoulli EM accuracy (clipped-normal
    ROUGE for summarization), jittered energy and latency."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def __call__(self, query: Query, model: str):
        task = query.task if query.task is not None else TaskType.QA
        mean_acc = mean_accuracy(model, task)
        if task == TaskType.SUMMARIZATION:
            acc = float(np.clip(self.rng.normal(mean_acc, 0.12), 0.0, 1.0))
        else:
            acc = float(self.rng.random() < mean_acc)
        e = mean_energy_mwh(model, task) * self.rng.uniform(0.85, 1.2) / 1e3
        tin, tout = TASK_TOKENS[task]
        latency_ms = (18.0 + 4.5 * PARAMS_B[model]
                      + (0.9 * PARAMS_B[model] + 0.5) * tout
                      ) * self.rng.uniform(0.9, 1.3)
        return acc, e, latency_ms, tout

    def oracle_tables(self, pool_names, task: TaskType):
        """(acc_by_model, energy_by_model) mean tables for regret oracles."""
        acc = np.array([mean_accuracy(m, task) for m in pool_names])
        energy = np.array([mean_energy_mwh(m, task) / 1e3
                           for m in pool_names])
        return acc, energy


# recommended reward normalization so λ interpolates meaningfully between
# [0,1]-accuracy and Wh-energy (paper normalizes accuracy only).  0.45 puts
# the λ=0.4 oracle at acc≈0.68 / ≈155 Wh per 2,500 queries — the paper's
# GreenServ operating point (Fig. 2a).
ENERGY_SCALE_WH = 0.45
