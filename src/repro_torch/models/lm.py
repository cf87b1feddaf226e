"""Decoder-only LM for serving: the dense layout.

Public surface:
    DenseLM / init_lm(cfg, seed, device)    modules with initialized params
    init_cache(cfg, batch, max_len, device) full-depth per-slot KV cache
    decode_step(model, token, cache, cfg)   one-token serve step
    prefill_chunk_step(model, toks, ...)    C-token prompt slab into the cache

The layer stack is a Python loop over ``nn.ModuleList`` blocks (the JAX
package scans stacked parameters).  Cache updates happen in place; the
returned cache is the same dict with its ``length`` advanced.  Layouts
other than ``dense`` — and dense stacks whose window is shorter than the
cache, which the JAX package serves from ring buffers — raise
``NotImplementedError``: they wait for later slices of the port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, embed, init_module_, mlp, param,
                                       rms_norm, unembed)

Cache = Dict[str, torch.Tensor]


def check_dense(cfg: ModelConfig) -> None:
    if cfg.layout != "dense":
        raise NotImplementedError(
            f"{cfg.name}: layout {cfg.layout!r} waits for the port's "
            f"model-families slice; this slice serves dense models")


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        self.norm_attn = param((cfg.d_model,), dt, device)
        self.attn = attn.Attention(cfg, device)
        self.norm_mlp = param((cfg.d_model,), dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class DenseLM(nn.Module):
    """Token embedding, ``n_layers`` dense blocks, final norm, LM head —
    parameter names and layouts as in the JAX tree (``tok/embed``,
    ``tok/unembed``, ``norm_f``, ``layers/...``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        check_dense(cfg)
        dt = cfg.torch_param_dtype()
        self.embed = param((cfg.vocab_size, cfg.d_model), dt, device)
        self.unembed = (None if cfg.tie_embeddings
                        else param((cfg.d_model, cfg.vocab_size), dt, device))
        self.norm_f = param((cfg.d_model,), dt, device)
        self.layers = nn.ModuleList(DenseBlock(cfg, device)
                                    for _ in range(cfg.n_layers))

    def logits(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        x = rms_norm(x, self.norm_f, cfg.norm_eps)
        return unembed(self.embed, self.unembed, x, cfg.torch_dtype())


def init_lm(cfg: ModelConfig, seed: int = 0,
            device: torch.device = torch.device("cpu")) -> DenseLM:
    """A DenseLM with the JAX package's init rule, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the weights
    are random, not the JAX package's draws: carry those with
    ``convert.params_from_jax``)."""
    model = DenseLM(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_module_(model, gen)
    return model


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: torch.device = torch.device("cpu")) -> Cache:
    """Full-depth per-slot KV cache: k/v (L, B, max_len, Hk, hd) in the
    compute dtype, length (B,) int32."""
    check_dense(cfg)
    if cfg.attn_pattern in ("swa", "local_global") and max_len > cfg.window:
        raise NotImplementedError(
            f"{cfg.name}: max_len {max_len} > window {cfg.window} needs the "
            f"ring-buffer cache, which waits for a later slice of the port")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.torch_dtype()
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Chunked serving prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_chunk_step(model: DenseLM, tokens: torch.Tensor, cache: Cache,
                       cfg: ModelConfig, n_active: torch.Tensor
                       ) -> Tuple[torch.Tensor, Cache]:
    """Populate the decode cache with a C-token prompt slab per slot.

    tokens: (B, C) int32 prompt tokens; slot b's slab lands at cache
    positions cache["length"][b] .. +n_active[b]-1.  ``n_active``: (B,)
    int32 — how many of the C positions are real tokens for each slot
    (0 = slot idle this step; positions past n_active are padding whose
    cache writes are masked out and whose logits are garbage).

    Returns (logits (B, C, V), the cache with per-slot lengths advanced by
    n_active).  With C == 1 and n_active == 1 this computes exactly what
    ``decode_step`` computes.
    """
    dtype = cfg.torch_dtype()
    c = tokens.shape[1]
    lengths = cache["length"]
    active = (torch.arange(c, dtype=torch.int32, device=tokens.device)[None, :]
              < n_active[:, None])                            # (B, C)
    x = embed(model.embed, tokens, dtype)
    windows = cfg.layer_windows(cache["k"].shape[2])
    for layer, k_c, v_c, window in zip(model.layers, cache["k"], cache["v"],
                                       windows):
        h = rms_norm(x, layer.norm_attn, cfg.norm_eps)
        x = x + attn.attention_prefill_chunk(layer.attn, h, k_c, v_c, window,
                                             lengths, active, cfg)
        h = rms_norm(x, layer.norm_mlp, cfg.norm_eps)
        x = x + mlp(layer.mlp, h, dtype)
    cache["length"] = lengths + n_active
    return model.logits(x, cfg), cache


# ---------------------------------------------------------------------------
# Single-token decode (serve_step body)
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(model: DenseLM, token: torch.Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """token: (B, 1) int32.  Returns (logits (B, 1, V), the cache with
    every slot's length advanced by one)."""
    dtype = cfg.torch_dtype()
    x = embed(model.embed, token, dtype)
    length = cache["length"]
    windows = cfg.layer_windows(cache["k"].shape[2])
    for layer, k_c, v_c, window in zip(model.layers, cache["k"], cache["v"],
                                       windows):
        h = rms_norm(x, layer.norm_attn, cfg.norm_eps)
        x = x + attn.attention_decode(layer.attn, h, k_c, v_c, window,
                                      length, cfg)
        h = rms_norm(x, layer.norm_mlp, cfg.norm_eps)
        x = x + mlp(layer.mlp, h, dtype)
    cache["length"] = length + 1
    return model.logits(x, cfg), cache

