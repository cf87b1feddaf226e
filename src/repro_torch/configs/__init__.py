"""Architecture registry: the ten configs of the JAX package (dense with
full, sliding-window and local:global attention, a vlm backbone, MoE,
RWKV6, a Mamba2 hybrid and an encoder-decoder), in its order, plus
reduced smoke variants.  ``configs/pool.py::build_assigned_pool`` orders
its arms by ``ARCH_IDS``.

Usage:
    from repro_torch.configs import get_config, for_mode, SHAPES
    cfg  = get_config("granite-3-8b")              # exact published dims
    tiny = get_config("granite-3-8b", smoke=True)  # reduced same-family config
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (gemma3_12b, gemma3_27b, granite_3_8b,
                                 grok_1_314b, h2o_danube_3_4b, llava_next_34b,
                                 qwen2_moe_a2_7b, rwkv6_1_6b, whisper_medium,
                                 zamba2_7b)
from repro_torch.configs.shapes import (SHAPES, ShapeCell, cell_applicable,
                                        input_specs, text_len)
from repro_torch.models.config import ModelConfig, scaled_down

_MODULES = [granite_3_8b, gemma3_27b, h2o_danube_3_4b, gemma3_12b,
            whisper_medium, zamba2_7b, llava_next_34b, rwkv6_1_6b,
            grok_1_314b, qwen2_moe_a2_7b]

REGISTRY: Dict[str, ModelConfig] = {m.ARCH_ID: m.CONFIG for m in _MODULES}
ARCH_IDS: List[str] = list(REGISTRY)


def get_config(arch_id: str, smoke: bool = False, **overrides) -> ModelConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg = REGISTRY[arch_id]
    if smoke:
        cfg = scaled_down(cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def for_mode(cfg: ModelConfig, mode: str) -> ModelConfig:
    """Serving stores weights in bf16 (no optimizer → no fp32 master
    needed); training keeps fp32 storage."""
    if mode in ("serve", "prefill", "decode"):
        return dataclasses.replace(cfg, param_dtype="bfloat16")
    return cfg


__all__ = ["REGISTRY", "ARCH_IDS", "get_config", "for_mode", "SHAPES",
           "ShapeCell", "cell_applicable", "input_specs", "text_len"]
