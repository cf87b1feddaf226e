"""Decoder-only LM: the dense and MoE layouts.

Public surface:
    DecoderLM / init_lm(cfg, seed, device)  modules with initialized params
    forward_hidden(model, tokens, cfg)      final-normed hiddens + MoE aux
    forward(model, tokens, cfg)             full logits + MoE aux (ForwardOut)
    init_cache(cfg, batch, max_len, device) full-depth per-slot KV cache
    decode_step(model, token, cache, cfg)   one-token serve step
    prefill_chunk_step(model, toks, ...)    C-token prompt slab into the cache

The layer stack is a Python loop over ``nn.ModuleList`` blocks (the JAX
package scans stacked parameters).  Cache updates happen in place; the
returned cache is the same dict with its ``length`` advanced.  Layouts
other than ``dense`` and ``moe`` — and stacks whose window is shorter than
the cache, which the JAX package serves from ring buffers — raise
``NotImplementedError``: they wait for later slices of the port.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, embed, init_module_, mlp, param,
                                       rms_norm, unembed)

Cache = Dict[str, torch.Tensor]


def check_layout(cfg: ModelConfig) -> None:
    if cfg.layout not in ("dense", "moe"):
        raise NotImplementedError(
            f"{cfg.name}: layout {cfg.layout!r} waits for a later "
            f"model-families slice of the port; dense and moe are served")


class DenseBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        self.norm_attn = param((cfg.d_model,), dt, device)
        self.attn = attn.Attention(cfg, device)
        self.norm_mlp = param((cfg.d_model,), dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class MoEBlock(nn.Module):
    """A dense block whose MLP is the capacity-dispatched expert layer
    (``layers/moe`` in the JAX tree)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        self.norm_attn = param((cfg.d_model,), dt, device)
        self.attn = attn.Attention(cfg, device)
        self.norm_mlp = param((cfg.d_model,), dt, device)
        self.moe = moe_lib.MoE(cfg, device)


class DecoderLM(nn.Module):
    """Token embedding, ``n_layers`` dense or MoE blocks, final norm, LM
    head — parameter names and layouts as in the JAX tree (``tok/embed``,
    ``tok/unembed``, ``norm_f``, ``layers/...``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        check_layout(cfg)
        dt = cfg.torch_param_dtype()
        self.embed = param((cfg.vocab_size, cfg.d_model), dt, device)
        self.unembed = (None if cfg.tie_embeddings
                        else param((cfg.d_model, cfg.vocab_size), dt, device))
        self.norm_f = param((cfg.d_model,), dt, device)
        block = MoEBlock if cfg.layout == "moe" else DenseBlock
        self.layers = nn.ModuleList(block(cfg, device)
                                    for _ in range(cfg.n_layers))

    def head(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """LM head on final-normed hiddens."""
        return unembed(self.embed, self.unembed, x, cfg.torch_dtype())

    def logits(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return self.head(rms_norm(x, self.norm_f, cfg.norm_eps), cfg)


def init_lm(cfg: ModelConfig, seed: int = 0, device=None) -> DecoderLM:
    """A DecoderLM with the JAX package's init rule, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card unless
    the caller names another).  The weights are random, not the JAX
    package's draws: carry those with ``convert.params_from_jax``."""
    device = resolve_device(device)
    model = DecoderLM(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_module_(model, gen)
    return model


def _ffn(layer: nn.Module, h: torch.Tensor, cfg: ModelConfig
         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The block's MLP half: (out, MoE aux loss or None for dense)."""
    if isinstance(layer, MoEBlock):
        return moe_lib.moe_block(layer.moe, h, cfg, use_pallas=cfg.use_pallas)
    return mlp(layer.mlp, h, cfg.torch_dtype()), None


# ---------------------------------------------------------------------------
# Full-sequence forward (one-shot prefill)
# ---------------------------------------------------------------------------


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor


@torch.no_grad()
def forward_hidden(model: DecoderLM, tokens: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S).  Returns (final-normed hidden states (B, S, d), MoE
    aux loss summed over layers — 0 for dense).  Every layer attends
    through ``attention.attention_prefill`` with its own window."""
    x = embed(model.embed, tokens, cfg.torch_dtype())
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, window in zip(model.layers, cfg.layer_windows(s)):
        h = rms_norm(x, layer.norm_attn, cfg.norm_eps)
        x = x + attn.attention_prefill(layer.attn, h, positions, window, cfg)
        m, layer_aux = _ffn(layer, rms_norm(x, layer.norm_mlp, cfg.norm_eps),
                            cfg)
        x = x + m
        if layer_aux is not None:
            aux = aux + layer_aux
    return rms_norm(x, model.norm_f, cfg.norm_eps), aux


def forward(model: DecoderLM, tokens: torch.Tensor,
            cfg: ModelConfig) -> ForwardOut:
    """Full logits (B, S, V) and the MoE aux loss."""
    x, aux = forward_hidden(model, tokens, cfg)
    return ForwardOut(model.head(x, cfg), aux)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Cache:
    """Full-depth per-slot KV cache on ``device`` (the card unless the
    caller names another): k/v (L, B, max_len, Hk, hd) in the compute
    dtype, length (B,) int32."""
    check_layout(cfg)
    if cfg.attn_pattern in ("swa", "local_global") and max_len > cfg.window:
        raise NotImplementedError(
            f"{cfg.name}: max_len {max_len} > window {cfg.window} needs the "
            f"ring-buffer cache, which waits for a later slice of the port")
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    dt = cfg.torch_dtype()
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "length": torch.zeros((batch,), dtype=torch.int32, device=device)}


# ---------------------------------------------------------------------------
# Chunked serving prefill
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill_chunk_step(model: DecoderLM, tokens: torch.Tensor, cache: Cache,
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
    ``decode_step`` computes.  MoE padding rows flow through dispatch but
    cannot evict real tokens: ``active`` is a prefix of each row and the
    capacity sort is stable (``moe._dispatch``).
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
        x = x + _ffn(layer, rms_norm(x, layer.norm_mlp, cfg.norm_eps), cfg)[0]
    cache["length"] = lengths + n_active
    return model.logits(x, cfg), cache


# ---------------------------------------------------------------------------
# Single-token decode (serve_step body)
# ---------------------------------------------------------------------------


@torch.no_grad()
def decode_step(model: DecoderLM, token: torch.Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """token: (B, 1) int32.  Returns (logits (B, 1, V), the cache with
    every slot's length advanced by one).  MoE layers route the B tokens
    as one dispatch group."""
    dtype = cfg.torch_dtype()
    x = embed(model.embed, token, dtype)
    length = cache["length"]
    windows = cfg.layer_windows(cache["k"].shape[2])
    for layer, k_c, v_c, window in zip(model.layers, cache["k"], cache["v"],
                                       windows):
        h = rms_norm(x, layer.norm_attn, cfg.norm_eps)
        x = x + attn.attention_decode(layer.attn, h, k_c, v_c, window,
                                      length, cfg)
        x = x + _ffn(layer, rms_norm(x, layer.norm_mlp, cfg.norm_eps), cfg)[0]
    cache["length"] = length + 1
    return model.logits(x, cfg), cache
