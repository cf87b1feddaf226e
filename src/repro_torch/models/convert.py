"""Carry a JAX LM's parameters into this package's modules.

``params_from_jax`` takes the JAX package's dense or MoE parameter tree —
the dict ``repro.models.api.init_params`` returns, with leaves as numpy
arrays (or anything ``numpy.asarray`` accepts) and per-layer leaves stacked
on a leading layer axis — and returns a ``DecoderLM`` holding the same
numbers.  Layouts are kept as they are at every einsum boundary, so both
packages contract the same axes; only the dtype follows
``cfg.param_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import DecoderLM


def _copy(dst: torch.Tensor, src, name: str) -> None:
    arr = np.array(src, dtype=np.float32)           # a writable copy
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"{name}: JAX shape {arr.shape} != {tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(arr))


def _copy_mlp(dst, tree: dict, i: int, prefix: str) -> None:
    for name in ("wi_gate", "wi_up", "wo"):
        _copy(getattr(dst, name), tree[name][i], f"{prefix}/{name}")


@torch.no_grad()
def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> DecoderLM:
    """The JAX tree's numbers in a ``DecoderLM`` on ``device`` (the card
    unless the caller names another)."""
    model = DecoderLM(cfg, resolve_device(device))
    _copy(model.embed, tree["tok"]["embed"], "tok/embed")
    if model.unembed is not None:
        _copy(model.unembed, tree["tok"]["unembed"], "tok/unembed")
    _copy(model.norm_f, tree["norm_f"], "norm_f")
    layers = tree["layers"]
    for i, block in enumerate(model.layers):
        _copy(block.norm_attn, layers["norm_attn"][i], f"layers/{i}/norm_attn")
        _copy(block.norm_mlp, layers["norm_mlp"][i], f"layers/{i}/norm_mlp")
        for name in ("wq", "wk", "wv", "wo"):
            _copy(getattr(block.attn, name), layers["attn"][name][i],
                  f"layers/{i}/attn/{name}")
        if cfg.layout == "moe":
            moe = layers["moe"]
            _copy(block.moe.router, moe["router"][i], f"layers/{i}/moe/router")
            _copy_mlp(block.moe, moe, i, f"layers/{i}/moe")
            if block.moe.shared is not None:
                _copy_mlp(block.moe.shared, moe["shared"], i,
                          f"layers/{i}/moe/shared")
        else:
            _copy_mlp(block.mlp, layers["mlp"], i, f"layers/{i}/mlp")
    return model
