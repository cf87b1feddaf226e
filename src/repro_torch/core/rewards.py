"""Reward scalarization + regret accounting (paper §3.2.1–3.2.2, Eq. 5–8, 12)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.types import RouterConfig


def scalarize(accuracy: float, energy_wh: float, lam: float,
              energy_scale_wh: float = 1.0) -> float:
    """Eq. 5: r = α·Acc − β·C  with α = 1−λ, β = λ.

    Energy is normalized by ``energy_scale_wh`` so both objectives share the
    [0, 1] scale before weighting (the paper normalizes accuracy and measures
    energy in Wh; a fixed divisor keeps the trade-off λ interpretable).
    """
    alpha, beta = 1.0 - lam, lam
    return alpha * float(accuracy) - beta * float(energy_wh) / energy_scale_wh


@dataclasses.dataclass
class RegretTracker:
    """Cumulative + instantaneous regret against the per-step oracle (Eq. 6–8).

    The oracle reward must be supplied by the evaluation harness (it requires
    counterfactual knowledge of every arm — available in simulation and in
    RouterBench-style offline matrices, unavailable in live serving).
    """

    cumulative: float = 0.0
    history: List[float] = dataclasses.field(default_factory=list)

    def step(self, chosen_reward: float, oracle_reward: float) -> float:
        inst = max(oracle_reward - chosen_reward, 0.0)
        self.cumulative += inst
        self.history.append(inst)
        return inst

    def moving_average(self, window: int = 50) -> np.ndarray:
        h = np.asarray(self.history, dtype=np.float64)
        if h.size == 0:
            return h
        kernel = np.ones(min(window, h.size)) / min(window, h.size)
        return np.convolve(h, kernel, mode="valid")

    def cumulative_curve(self) -> np.ndarray:
        return np.cumsum(np.asarray(self.history, dtype=np.float64))


class RewardManager:
    """Computes scalarized rewards and tracks running statistics."""

    def __init__(self, config: RouterConfig):
        self.config = config
        self.total_accuracy = 0.0
        self.total_energy_wh = 0.0
        self.n = 0

    def reward(self, accuracy: float, energy_wh: float) -> float:
        self.total_accuracy += accuracy
        self.total_energy_wh += energy_wh
        self.n += 1
        return scalarize(accuracy, energy_wh, self.config.lam,
                         self.config.energy_scale_wh)

    @property
    def mean_accuracy(self) -> float:
        return self.total_accuracy / max(self.n, 1)
