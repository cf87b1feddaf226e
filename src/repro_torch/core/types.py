"""Core datatypes shared across the GreenServ framework.

Plain dataclasses: router state that lives on the device is held as
tensors in ``bandits.py`` and ``context.py``.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Mapping, Optional, Sequence


class TaskType(enum.IntEnum):
    """The five benchmark task families used in the paper (§6.1.2)."""

    QA = 0            # MMLU-style multiple-choice question answering
    COMPLETION = 1    # HellaSwag-style situation completion
    REASONING = 2     # Winogrande-style commonsense reasoning
    MATH = 3          # GSM8K-style math word problems
    SUMMARIZATION = 4 # CNN/DailyMail-style summarization

    @classmethod
    def names(cls) -> Sequence[str]:
        return [t.name.lower() for t in cls]


N_TASKS = len(TaskType)


@dataclasses.dataclass(frozen=True)
class Query:
    """A single inference request in the stream {q_t}."""

    uid: int
    text: str
    task: Optional[TaskType] = None       # ground-truth task label (hidden from router)
    reference: Optional[str] = None       # ground-truth answer for accuracy eval
    max_new_tokens: int = 64
    latency_budget_ms: float = float("inf")
    arrival_s: float = 0.0

    def __post_init__(self) -> None:
        if not self.text:
            raise ValueError("Query.text must be non-empty")


@dataclasses.dataclass(frozen=True)
class ContextVector:
    """The structured context x_t = [task, cluster, complexity] (paper §4.2.4)."""

    task_label: int
    cluster: int
    complexity_bin: int
    complexity_score: float
    vector: Any  # np.ndarray one-hot + intercept, shape (d,)

    @property
    def dim(self) -> int:
        return int(self.vector.shape[0])


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Outcome of one routing step: which arm, with what expected scores."""

    query_uid: int
    model_index: int
    model_name: str
    context: ContextVector
    ucb_scores: Any            # per-arm scores at decision time (masked arms = -inf)
    feasible_mask: Any         # bool per arm
    overhead_ms: float         # feature extraction + bandit decision time
    timestamp_s: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass(frozen=True)
class Feedback:
    """Observed partial feedback for the selected arm only (paper §3.2.2)."""

    query_uid: int
    model_index: int
    accuracy: float            # normalized to [0, 1]
    energy_wh: float           # measured/modeled energy for this query
    latency_ms: float
    input_tokens: int = 0
    output_tokens: int = 0


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """Static metadata for a pool member (the router never peeks at accuracy)."""

    name: str
    family: str
    params_b: float                       # billions of parameters
    arch_config: Optional[Any] = None     # models.ModelConfig when backed by a real model
    # conservative latency estimate used by the feasibility filter (paper §4.3:
    # MaxNewTokens-based estimate); ms per generated token + fixed prefill cost.
    ms_per_token: float = 10.0
    prefill_ms: float = 50.0
    placement: Optional[str] = None       # mesh slice label for pool placement

    def latency_estimate_ms(self, max_new_tokens: int) -> float:
        return self.prefill_ms + self.ms_per_token * max_new_tokens


@dataclasses.dataclass
class RouterConfig:
    """Hyperparameters (paper §6.1.5 defaults)."""

    lam: float = 0.4                  # λ accuracy/energy trade-off
    alpha_ucb: float = 0.1            # LinUCB exploration coefficient
    lambda_reg: float = 0.05          # ridge prior on A_m
    epsilon0: float = 1.0             # ε-greedy initial exploration
    epsilon_decay: float = 0.98
    epsilon_min: float = 0.01
    cts_sigma: float = 0.01           # Thompson sampling posterior scale
    n_clusters: int = 3               # K for online k-means
    n_complexity_bins: int = 3        # N_bins for Flesch binning
    n_tasks: int = N_TASKS
    max_arms: int = 64                # static arm capacity: fixed state shapes
    energy_scale_wh: float = 1.0      # energy normalization divisor in reward
    algorithm: str = "linucb"         # linucb | cts | eps_greedy | eps_greedy_ctx
    solve_mode: str = "sherman_morrison"  # paper-faithful alternative: "cholesky"
    # featurization placement: "device" runs the fused featurize→score
    # pipeline (kernels/featurize + kernels/linucb on the router's device),
    # "host" is the reference numpy path, "auto" picks device when the
    # router's device is CUDA (elsewhere the kernels' plain PyTorch
    # versions would run — a correctness tool, not a fast path).  Both
    # paths agree; stochastic bandit algorithms and the cholesky solve
    # mode always fall back to host.
    featurize: str = "auto"           # auto | host | device
    seed: int = 0

    def resolve_featurize_device(self, device) -> bool:
        """True when the device featurize→score pipeline should run for
        a router placed on ``device``."""
        if self.featurize == "host":
            return False
        if self.featurize == "device":
            return True
        if self.featurize != "auto":
            raise ValueError(
                f"featurize must be auto|host|device, got {self.featurize!r}")
        import torch
        return torch.device(device).type == "cuda"

    @property
    def context_dim(self) -> int:
        # one-hot task + one-hot cluster + one-hot complexity bin + intercept
        return self.n_tasks + self.n_clusters + self.n_complexity_bins + 1


def validate_unit_interval(x: float, name: str) -> float:
    if not (0.0 <= x <= 1.0):
        raise ValueError(f"{name} must be in [0, 1], got {x}")
    return x
