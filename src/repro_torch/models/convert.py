"""Carry a JAX LM's parameters into this package's modules.

``params_from_jax`` takes the JAX package's dense (tied embeddings
included: gemma3's tree has ``tok/embed`` alone, used as the LM head),
MoE, RWKV6 or Mamba2-hybrid parameter tree —
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


def _copy_params(dst, tree: dict, i: int, prefix: str) -> None:
    """Every direct parameter of ``dst`` from the same-named leaf of
    ``tree`` at layer ``i``."""
    for name, p in dst.named_parameters(recurse=False):
        _copy(p, tree[name][i], f"{prefix}/{name}")


def _copy_attn_block(block, tree: dict, i: int, prefix: str) -> None:
    """A dense or MoE block from layer ``i`` of a stacked tree."""
    _copy(block.norm_attn, tree["norm_attn"][i], f"{prefix}/norm_attn")
    _copy(block.norm_mlp, tree["norm_mlp"][i], f"{prefix}/norm_mlp")
    for name in ("wq", "wk", "wv", "wo"):
        _copy(getattr(block.attn, name), tree["attn"][name][i],
              f"{prefix}/attn/{name}")
    if "moe" in tree:
        moe = tree["moe"]
        _copy(block.moe.router, moe["router"][i], f"{prefix}/moe/router")
        _copy_mlp(block.moe, moe, i, f"{prefix}/moe")
        if block.moe.shared is not None:
            _copy_mlp(block.moe.shared, moe["shared"], i,
                      f"{prefix}/moe/shared")
    else:
        _copy_mlp(block.mlp, tree["mlp"], i, f"{prefix}/mlp")


def _stacked(tree):
    """``tree`` with a leading layer axis of 1 on every leaf."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return np.asarray(tree)[None]


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
        prefix = f"layers/{i}"
        if cfg.layout == "rwkv":
            _copy_params(block, layers, i, prefix)
            _copy_params(block.rwkv, layers["rwkv"], i, f"{prefix}/rwkv")
        elif cfg.layout == "mamba_hybrid":
            _copy_params(block, layers, i, prefix)
            _copy_params(block.mamba, layers["mamba"], i, f"{prefix}/mamba")
        else:
            _copy_attn_block(block, layers, i, prefix)
    if model.shared_attn is not None:
        _copy_attn_block(model.shared_attn, _stacked(tree["shared_attn"]), 0,
                         "shared_attn")
    return model
