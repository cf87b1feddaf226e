"""Carry a JAX LM's parameters into this package's modules.

``params_from_jax`` takes the JAX package's dense (tied embeddings
included: gemma3's tree has ``tok/embed`` alone, used as the LM head),
MoE, RWKV6, Mamba2-hybrid or encoder-decoder parameter tree — the dict
``repro.models.api.init_params`` returns, with leaves as numpy arrays (or
anything ``numpy.asarray`` accepts) and per-layer leaves stacked on a
leading layer axis — and returns a ``DecoderLM`` (an ``EncDecLM``)
holding the same numbers.  Layouts are kept as they are at every einsum boundary, so both
packages contract the same axes; only the dtype follows
``cfg.param_dtype``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.encdec import EncDecLM
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


def _copy_attn(dst, tree: dict, i: int, prefix: str) -> None:
    for name in ("wq", "wk", "wv", "wo"):
        _copy(getattr(dst, name), tree[name][i], f"{prefix}/{name}")


def _copy_attn_block(block, tree: dict, i: int, prefix: str) -> None:
    """A dense or MoE block from layer ``i`` of a stacked tree."""
    _copy(block.norm_attn, tree["norm_attn"][i], f"{prefix}/norm_attn")
    _copy(block.norm_mlp, tree["norm_mlp"][i], f"{prefix}/norm_mlp")
    _copy_attn(block.attn, tree["attn"], i, f"{prefix}/attn")
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


def _copy_encdec(model: EncDecLM, tree: dict) -> None:
    """The encoder and decoder stacks and their final norms."""
    enc, dec = tree["enc_layers"], tree["dec_layers"]
    for i, layer in enumerate(model.enc_layers):
        prefix = f"enc_layers/{i}"
        _copy_params(layer, enc, i, prefix)
        _copy_attn(layer.attn, enc["attn"], i, f"{prefix}/attn")
        _copy_mlp(layer.mlp, enc["mlp"], i, f"{prefix}/mlp")
    for i, layer in enumerate(model.dec_layers):
        prefix = f"dec_layers/{i}"
        _copy_params(layer, dec, i, prefix)
        for name in ("self_attn", "cross_attn"):
            _copy_attn(getattr(layer, name), dec[name], i,
                       f"{prefix}/{name}")
        _copy_mlp(layer.mlp, dec["mlp"], i, f"{prefix}/mlp")
    _copy(model.norm_enc, tree["norm_enc"], "norm_enc")
    _copy(model.norm_dec, tree["norm_dec"], "norm_dec")


@torch.no_grad()
def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> DecoderLM:
    """The JAX tree's numbers in a ``DecoderLM`` (an ``EncDecLM`` for the
    encdec layout) on ``device`` (the card unless the caller names
    another)."""
    device = resolve_device(device)
    model = (EncDecLM(cfg, device) if cfg.layout == "encdec"
             else DecoderLM(cfg, device))
    _copy(model.embed, tree["tok"]["embed"], "tok/embed")
    if model.unembed is not None:
        _copy(model.unembed, tree["tok"]["unembed"], "tok/unembed")
    if cfg.layout == "encdec":
        _copy_encdec(model, tree)
        return model
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
