"""Model pools: the paper's 16-model pool and the assigned-architecture pool.

The paper's pool (Table 2) is reproduced as profiles with parameter counts
and analytic latency estimates; per-(model, task) accuracy/energy behaviour
lives in ``repro_torch.data.profiles`` (calibrated to the paper's
aggregates).

The assigned-architecture pool makes the ten configs of ``configs/``
routable pool members, each backed by its ``ModelConfig``, so the
router's energy signal can come from the analytic cost model.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.energy import CostModelParams
from repro_torch.core.pool import ModelPool
from repro_torch.core.types import ModelProfile
from repro_torch.models.config import ModelConfig

# (name, family, params_b) — paper Table 2, ordered as the paper lists them.
PAPER_POOL = [
    ("qwen2.5-0.5b", "qwen", 0.5),
    ("qwen2.5-1.5b", "qwen", 1.5),
    ("qwen2.5-3b", "qwen", 3.0),
    ("qwen2.5-7b", "qwen", 7.0),
    ("qwen2.5-14b", "qwen", 14.0),
    ("mistral-7b", "mistral", 7.0),
    ("gemma-3-1b", "gemma", 1.0),
    ("gemma-3-4b", "gemma", 4.0),
    ("gemma-3-12b", "gemma", 12.0),
    ("gemma-3-27b", "gemma", 27.0),
    ("llama-3.1-1b", "llama", 1.0),
    ("llama-3.2-3b", "llama", 3.0),
    ("llama-3.1-8b", "llama", 8.0),
    ("phi-4-mini-4b", "phi", 4.0),
    ("phi-4-14b", "phi", 14.0),
    ("yi-34b", "yi", 34.0),
]

# Models the paper holds out of the initial pool for the adaptability
# experiment (§6.2.4: gemma-3-12b joins at query 1000).
ADDITION_MODEL = "gemma-3-12b"


def _latency_profile(params_b: float) -> tuple:
    """(ms_per_token, prefill_ms): weight-bandwidth-bound decode + a fixed
    dispatch floor, shaped to reproduce the ordering in paper Table 3."""
    ms_per_token = 0.9 * params_b + 0.5
    prefill_ms = 18.0 + 4.5 * params_b
    return ms_per_token, prefill_ms


def make_profile(name: str, family: str, params_b: float) -> ModelProfile:
    mpt, pre = _latency_profile(params_b)
    return ModelProfile(name=name, family=family, params_b=params_b,
                        ms_per_token=mpt, prefill_ms=pre)


def build_paper_pool(exclude: Optional[List[str]] = None) -> ModelPool:
    """The 16-arm pool of the paper's experiments (optionally holding models
    out for the §6.2.4 addition experiment)."""
    exclude = set(exclude or [])
    unknown = exclude - {row[0] for row in PAPER_POOL}
    if unknown:
        # a typo'd exclude silently running the full 16-model pool is a
        # miscalibrated experiment, not a smaller one — fail loudly
        raise ValueError(f"exclude names not in PAPER_POOL: "
                         f"{sorted(unknown)}")
    return ModelPool([make_profile(*row) for row in PAPER_POOL
                      if row[0] not in exclude])


def cost_model_params(cfg: ModelConfig) -> CostModelParams:
    return CostModelParams(
        n_params=float(cfg.param_count()),
        n_active_params=float(cfg.active_param_count()),
        d_model=cfg.d_model,
        n_layers=cfg.n_layers,
        kv_heads=max(cfg.n_kv_heads, 1),
        head_dim=cfg.head_dim,
    )


def build_assigned_pool() -> ModelPool:
    """The ten configs as routable GreenServ pool members, in ``ARCH_IDS``'s
    order."""
    from repro_torch.configs import ARCH_IDS, get_config
    profiles = []
    for arch_id in ARCH_IDS:
        cfg = get_config(arch_id)
        params_b = cfg.param_count() / 1e9
        mpt, pre = _latency_profile(cfg.active_param_count() / 1e9)
        profiles.append(ModelProfile(
            name=arch_id, family=cfg.layout, params_b=params_b,
            arch_config=cfg, ms_per_token=mpt, prefill_ms=pre))
    return ModelPool(profiles)
