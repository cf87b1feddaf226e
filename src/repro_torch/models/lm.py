"""Decoder-only LM: the dense, MoE, RWKV6 and Mamba2-hybrid layouts.

Public surface:
    DecoderLM / init_lm(cfg, seed, device)  modules with initialized params
    forward_hidden(model, tokens, cfg)      final-normed hiddens + MoE aux
    forward(model, tokens, cfg)             full logits + MoE aux (ForwardOut)
    init_cache(cfg, batch, max_len, device) decode cache (ring buffers for
                                            windowed layers deeper than
                                            their window)
    decode_step(model, token, cache, cfg)   one-token serve step, per-slot
                                            or lockstep lengths
    prefill_chunk_step(model, toks, ...)    C-token prompt slab into the cache
                                            (dense and MoE only)

The layer stack is a Python loop over ``nn.ModuleList`` blocks (the JAX
package scans stacked parameters).  The hybrid's shared attention block
(``shared_attn``) is one module applied after every ``attn_every``-th
Mamba layer, the same weights at every site.  Dense sliding-window and
local:global stacks whose window is shorter than the cache keep ring
buffers of the window's size for their local layers (``k_local`` /
``v_local``) beside full-depth caches for their global ones
(``k_global`` / ``v_global``), as the JAX package's ``cache_shapes``.
Cache updates happen in place; the returned cache is the same dict with
its ``length`` advanced — a (B,) vector of per-slot lengths, or a 0-d
length when every row decodes in lockstep, which stays 0-d.  The
``encdec`` layout raises ``NotImplementedError``: it waits for a later
slice of the port.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, embed, init_module_, mlp, param,
                                       rms_norm, unembed)

Cache = Dict[str, torch.Tensor]


def check_layout(cfg: ModelConfig) -> None:
    if cfg.layout not in ("dense", "moe", "rwkv", "mamba_hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: layout {cfg.layout!r} waits for a later "
            f"model-families slice of the port; dense, moe, rwkv and "
            f"mamba_hybrid are served")


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


_BLOCKS = {"dense": DenseBlock, "moe": MoEBlock,
           "rwkv": rwkv_lib.RWKVBlock, "mamba_hybrid": ssm_lib.MambaBlock}


class DecoderLM(nn.Module):
    """Token embedding, ``n_layers`` blocks of the layout, final norm, LM
    head, and for the hybrid the one ``shared_attn`` dense block —
    parameter names and layouts as in the JAX tree (``tok/embed``,
    ``tok/unembed``, ``norm_f``, ``layers/...``, ``shared_attn/...``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        check_layout(cfg)
        dt = cfg.torch_param_dtype()
        self.embed = param((cfg.vocab_size, cfg.d_model), dt, device)
        self.unembed = (None if cfg.tie_embeddings
                        else param((cfg.d_model, cfg.vocab_size), dt, device))
        self.norm_f = param((cfg.d_model,), dt, device)
        block = _BLOCKS[cfg.layout]
        self.layers = nn.ModuleList(block(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.shared_attn = (DenseBlock(cfg, device)
                            if cfg.layout == "mamba_hybrid" else None)

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


def _attn_block(layer: nn.Module, x: torch.Tensor, positions: torch.Tensor,
                window: int, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One dense or MoE block over a whole sequence: (x, MoE aux or
    None)."""
    h = rms_norm(x, layer.norm_attn, cfg.norm_eps)
    x = x + attn.attention_prefill(layer.attn, h, positions, window, cfg)
    m, layer_aux = _ffn(layer, rms_norm(x, layer.norm_mlp, cfg.norm_eps), cfg)
    return x + m, layer_aux


@torch.no_grad()
def forward_hidden(model: DecoderLM, tokens: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S).  Returns (final-normed hidden states (B, S, d), MoE
    aux loss summed over layers — 0 for the other layouts).  Dense and
    MoE layers attend through ``attention.attention_prefill`` with their
    own window; RWKV layers start from a zero state each; the hybrid runs
    its shared attention block, window S, after every ``attn_every``-th
    Mamba layer."""
    x = embed(model.embed, tokens, cfg.torch_dtype())
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.layout in ("dense", "moe"):
        for layer, window in zip(model.layers, cfg.layer_windows(s)):
            x, layer_aux = _attn_block(layer, x, positions, window, cfg)
            if layer_aux is not None:
                aux = aux + layer_aux
    elif cfg.layout == "rwkv":
        for layer in model.layers:
            st = rwkv_lib.init_rwkv_state(cfg, b, x.device)
            h, st = rwkv_lib.rwkv_time_mix(
                layer.rwkv, rms_norm(x, layer.ln1, cfg.norm_eps), st, cfg)
            x = x + h
            h, _ = rwkv_lib.rwkv_channel_mix(
                layer.rwkv, rms_norm(x, layer.ln2, cfg.norm_eps), st, cfg)
            x = x + h
    else:                                       # mamba_hybrid
        for idx, layer in enumerate(model.layers):
            h, _ = ssm_lib.mamba_prefill(
                layer.mamba, rms_norm(x, layer.norm, cfg.norm_eps), cfg)
            x = x + h
            if (idx + 1) % cfg.attn_every == 0:
                x, _ = _attn_block(model.shared_attn, x, positions, s, cfg)
    return rms_norm(x, model.norm_f, cfg.norm_eps), aux


def forward(model: DecoderLM, tokens: torch.Tensor,
            cfg: ModelConfig) -> ForwardOut:
    """Full logits (B, S, V) and the MoE aux loss."""
    x, aux = forward_hidden(model, tokens, cfg)
    return ForwardOut(model.head(x, cfg), aux)


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------


def _windowed(cfg: ModelConfig, max_len: int) -> bool:
    """Whether the decode cache keeps ring buffers: a dense sliding-window
    or local:global stack whose window is shorter than the cache (the JAX
    package's rule; an MoE stack keeps full-depth caches)."""
    return (cfg.layout == "dense"
            and cfg.attn_pattern in ("swa", "local_global")
            and max_len > cfg.window)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Cache:
    """Per-slot decode cache on ``device`` (the card unless the caller
    names another), as the JAX package's ``cache_shapes``; every layout
    has ``length`` (B,) int32 (set it to a 0-d tensor to decode every row
    in lockstep).

    dense / moe: full-depth k/v (L, B, max_len, Hk, hd) in the compute
    dtype — or, where ``_windowed``, k_local/v_local (n_local, B, W, Hk,
    hd) rings of W = min(window, max_len) for the layers whose window is
    shorter than max_len, plus k_global/v_global (n_global, B, max_len,
    Hk, hd) for the others (local:global only).  rwkv: the recurrent
    state, shift_tm/shift_cm (L, B, d) and wkv (L, B, H, K, K), fp32.
    mamba_hybrid: conv (L, B, conv-1, d_inner+2n) in the compute dtype,
    ssm (L, B, H, 64, n) fp32, and the shared block's attn_k/attn_v
    (n_sites, B, max_len, Hk, hd), one per site."""
    check_layout(cfg)
    device = resolve_device(device)
    dt = cfg.torch_dtype()
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    L = cfg.n_layers
    cache = {"length": zeros((batch,), torch.int32)}
    if cfg.layout == "rwkv":
        h, kd = rwkv_lib.rwkv_dims(cfg)
        cache.update(shift_tm=zeros((L, batch, cfg.d_model), torch.float32),
                     shift_cm=zeros((L, batch, cfg.d_model), torch.float32),
                     wkv=zeros((L, batch, h, kd, kd), torch.float32))
    elif cfg.layout == "mamba_hybrid":
        d_inner, h, n = ssm_lib.mamba_dims(cfg)
        kv = (L // cfg.attn_every, batch, max_len, cfg.n_kv_heads,
              cfg.head_dim)
        cache.update(
            conv=zeros((L, batch, cfg.ssm_conv - 1, d_inner + 2 * n), dt),
            ssm=zeros((L, batch, h, ssm_lib.MAMBA_HEAD_DIM, n),
                      torch.float32),
            attn_k=zeros(kv, dt), attn_v=zeros(kv, dt))
    elif _windowed(cfg, max_len):
        n_local = sum(w < max_len for w in cfg.layer_windows(max_len))
        kd = (cfg.n_kv_heads, cfg.head_dim)
        ring = (n_local, batch, min(cfg.window, max_len)) + kd
        cache.update(k_local=zeros(ring, dt), v_local=zeros(ring, dt))
        if n_local < L:
            full = (L - n_local, batch, max_len) + kd
            cache.update(k_global=zeros(full, dt), v_global=zeros(full, dt))
    else:
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        cache.update(k=zeros(shape, dt), v=zeros(shape, dt))
    return cache


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
    capacity sort is stable (``moe._dispatch``).  Recurrent layouts have
    no positional cache to take a slab at an offset, and raise.
    """
    if cfg.layout not in ("dense", "moe") or "k" not in cache:
        raise ValueError(
            f"chunked prefill unsupported for layout={cfg.layout!r} / cache "
            f"keys {sorted(cache)}; use the one-token decode path")
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


def _attn_decode(layer: nn.Module, x: torch.Tensor, k_c: torch.Tensor,
                 v_c: torch.Tensor, window: int, length: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, layer.norm_attn, cfg.norm_eps)
    x = x + attn.attention_decode(layer.attn, h, k_c, v_c, window, length,
                                  cfg)
    return x + _ffn(layer, rms_norm(x, layer.norm_mlp, cfg.norm_eps), cfg)[0]


def _decode_local(layer: nn.Module, x: torch.Tensor, k_ring: torch.Tensor,
                  v_ring: torch.Tensor, length: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """A dense block whose attention decodes against its ring buffer."""
    h = rms_norm(x, layer.norm_attn, cfg.norm_eps)
    x = x + attn.attention_decode_ring(layer.attn, h, k_ring, v_ring, length,
                                       cfg)
    return x + _ffn(layer, rms_norm(x, layer.norm_mlp, cfg.norm_eps), cfg)[0]


def _decode_windowed(model: DecoderLM, x: torch.Tensor, cache: Cache,
                     cfg: ModelConfig) -> torch.Tensor:
    """Decode through a windowed (ring-buffer) cache, in the JAX package's
    layer order and cache indices.  swa: every layer attends through its
    W-slot ring.  local:global: groups of ``local_per_global`` ring layers
    and one global layer (window = the cache depth) against its full-depth
    cache, then any trailing layers past the last group on rings."""
    length = cache["length"]
    p = cfg.local_per_global + 1
    n_local = n_global = 0
    for l, layer in enumerate(model.layers):
        if "k_global" in cache and l % p == p - 1:
            x = _attn_decode(layer, x, cache["k_global"][n_global],
                             cache["v_global"][n_global],
                             cache["k_global"].shape[2], length, cfg)
            n_global += 1
        else:
            x = _decode_local(layer, x, cache["k_local"][n_local],
                              cache["v_local"][n_local], length, cfg)
            n_local += 1
    return x


@torch.no_grad()
def decode_step(model: DecoderLM, token: torch.Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """token: (B, 1) int32.  Returns (logits (B, 1, V), the cache with
    every slot's length advanced by one and its state written in place).
    ``cache["length"]`` is a (B,) vector (per-slot lengths) or a 0-d
    tensor (every row in lockstep, which stays 0-d).  MoE layers route the
    B tokens as one dispatch group.  Windowed caches run the ring layers
    and the global layers in the JAX package's order.  The hybrid runs its
    Mamba layers one step each and the shared block's decode at every
    site, against that site's own KV cache."""
    dtype = cfg.torch_dtype()
    x = embed(model.embed, token, dtype)
    length = cache["length"]
    if cfg.layout in ("dense", "moe") and "k_local" in cache:
        x = _decode_windowed(model, x, cache, cfg)
    elif cfg.layout in ("dense", "moe"):
        windows = cfg.layer_windows(cache["k"].shape[2])
        for layer, k_c, v_c, window in zip(model.layers, cache["k"],
                                           cache["v"], windows):
            x = _attn_decode(layer, x, k_c, v_c, window, length, cfg)
    elif cfg.layout == "rwkv":
        for l, layer in enumerate(model.layers):
            st = rwkv_lib.RwkvLayerState(cache["shift_tm"][l],
                                         cache["shift_cm"][l],
                                         cache["wkv"][l])
            h, st = rwkv_lib.rwkv_time_mix(
                layer.rwkv, rms_norm(x, layer.ln1, cfg.norm_eps), st, cfg,
                decode=True)
            x = x + h
            h, st = rwkv_lib.rwkv_channel_mix(
                layer.rwkv, rms_norm(x, layer.ln2, cfg.norm_eps), st, cfg)
            x = x + h
            for name, new in zip(st._fields, st):
                cache[name][l].copy_(new)
    else:                                       # mamba_hybrid
        s_max = cache["attn_k"].shape[2]
        for idx, layer in enumerate(model.layers):
            h, (conv_s, ssm_s) = ssm_lib.mamba_decode(
                layer.mamba, rms_norm(x, layer.norm, cfg.norm_eps),
                cache["conv"][idx], cache["ssm"][idx], cfg)
            x = x + h
            cache["conv"][idx].copy_(conv_s)
            cache["ssm"][idx].copy_(ssm_s)
            if (idx + 1) % cfg.attn_every == 0:
                site = (idx + 1) // cfg.attn_every - 1
                x = _attn_decode(model.shared_attn, x, cache["attn_k"][site],
                                 cache["attn_v"][site], s_max, length, cfg)
    cache["length"] = length + 1
    return model.logits(x, cfg), cache
