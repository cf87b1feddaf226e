"""Encoder-decoder (whisper-style) assembly.

The audio frontend is a stub, as in the JAX package: the caller gives
precomputed frame embeddings (B, n_frames, d_model); the conv feature
extractor of the real Whisper is out of scope, only the transformer
backbone runs.

Encoder: bidirectional full-attention blocks over the frames.  Decoder:
causal self-attention, cross-attention to the encoder output, MLP.
Decode caches: per-layer self K/V (grows) plus cross K/V (static, from the
encoder output once per request; the serving engine leaves them zero for
the stub frontend, as the JAX package's engine does).

The encoder's self-attention and the teacher-forced cross-attention
(``attention.attention_prefill`` with ``kv_override``) run the plain
non-causal ``attention.flash_prefill`` whatever ``cfg.use_pallas`` says,
as in the JAX package; the decoder's self-attention goes through
``attention.attention_prefill`` (the flash kernel under
``cfg.use_pallas``).  Parameter names and layouts are the
JAX tree's (``tok/embed``, ``enc_layers/...``, ``dec_layers/...``,
``norm_enc``, ``norm_dec``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (MLP, embed, init_module_, mlp, param,
                                       rms_norm, unembed)

Cache = Dict[str, torch.Tensor]


class EncoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        self.norm_attn = param((cfg.d_model,), dt, device)
        self.attn = attn.Attention(cfg, device)
        self.norm_mlp = param((cfg.d_model,), dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        self.norm_self = param((cfg.d_model,), dt, device)
        self.self_attn = attn.Attention(cfg, device)
        self.norm_cross = param((cfg.d_model,), dt, device)
        self.cross_attn = attn.Attention(cfg, device)
        self.norm_mlp = param((cfg.d_model,), dt, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, dt, device)


class EncDecLM(nn.Module):
    """Token embedding (the LM head too when tied), ``n_encoder_layers``
    encoder layers, ``n_layers`` decoder layers and the two final norms —
    the tree of the JAX package's ``encdec_shapes``."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        dt = cfg.torch_param_dtype()
        self.embed = param((cfg.vocab_size, cfg.d_model), dt, device)
        self.unembed = (None if cfg.tie_embeddings
                        else param((cfg.d_model, cfg.vocab_size), dt, device))
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, device)
                                        for _ in range(cfg.n_encoder_layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.norm_enc = param((cfg.d_model,), dt, device)
        self.norm_dec = param((cfg.d_model,), dt, device)

    def head(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        """LM head on final-normed hiddens."""
        return unembed(self.embed, self.unembed, x, cfg.torch_dtype())

    def logits(self, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
        return self.head(rms_norm(x, self.norm_dec, cfg.norm_eps), cfg)


def init_encdec(cfg: ModelConfig, seed: int = 0, device=None) -> EncDecLM:
    """An EncDecLM with the JAX package's init rule, drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the card unless
    the caller names another)."""
    device = resolve_device(device)
    model = EncDecLM(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    init_module_(model, gen)
    return model


def _positions(b: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


def encode(model: EncDecLM, frames: torch.Tensor,
           cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, n_frames, d_model) stub embeddings → the final-normed
    encoder output (B, n_frames, d_model)."""
    x = frames.to(cfg.torch_dtype())
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    for layer in model.enc_layers:
        h = rms_norm(x, layer.norm_attn, cfg.norm_eps)
        q, k, v = attn.project_qkv(layer.attn, h, positions, cfg)
        o = attn.flash_prefill(q, k, v, s, cfg.attn_chunk, causal=False)
        x = x + torch.einsum("bshk,hkd->bsd", o, layer.attn.wo.to(x.dtype))
        x = x + mlp(layer.mlp, rms_norm(x, layer.norm_mlp, cfg.norm_eps),
                    cfg.torch_dtype())
    return rms_norm(x, model.norm_enc, cfg.norm_eps)


def cross_kv(layer: DecoderLayer, enc_out: torch.Tensor,
             cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder layer's cross K/V from the encoder output: (B,
    n_frames, Hk, hd) each."""
    dt = cfg.torch_dtype()
    k = torch.einsum("bsd,dhk->bshk", enc_out, layer.cross_attn.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, layer.cross_attn.wv.to(dt))
    return k, v


def forward_hidden(model: EncDecLM, frames: torch.Tensor,
                   tokens: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-forced forward up to the final decoder norm: (hidden (B, S,
    d), aux loss 0)."""
    enc_out = encode(model, frames, cfg)
    x = embed(model.embed, tokens, cfg.torch_dtype())
    b, s, _ = x.shape
    positions = _positions(b, s, x.device)
    # cross-attention: no RoPE, every frame within the window of the
    # frames' count from the query, the plain path whatever use_pallas says
    plain = dataclasses.replace(cfg, use_pallas=False)
    for layer in model.dec_layers:
        h = rms_norm(x, layer.norm_self, cfg.norm_eps)
        x = x + attn.attention_prefill(layer.self_attn, h, positions, s, cfg)
        h = rms_norm(x, layer.norm_cross, cfg.norm_eps)
        x = x + attn.attention_prefill(
            layer.cross_attn, h, positions, enc_out.shape[1], plain,
            rope=False, kv_override=cross_kv(layer, enc_out, cfg))
        x = x + mlp(layer.mlp, rms_norm(x, layer.norm_mlp, cfg.norm_eps),
                    cfg.torch_dtype())
    x = rms_norm(x, model.norm_dec, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Cache:
    """The JAX package's ``cache_shapes``, zeros on ``device``: self K/V
    (L, B, max_len, Hk, hd) and cross K/V (L, B, n_frontend_tokens, Hk, hd)
    in the compute dtype, ``length`` (B,) int32."""
    device = resolve_device(device)
    dt = cfg.torch_dtype()
    kd = (cfg.n_kv_heads, cfg.head_dim)
    kv = (cfg.n_layers, batch, max_len) + kd
    cross = (cfg.n_layers, batch, cfg.n_frontend_tokens) + kd
    zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    return {"k": zeros(kv, dt), "v": zeros(kv, dt),
            "cross_k": zeros(cross, dt), "cross_v": zeros(cross, dt),
            "length": zeros((batch,), torch.int32)}


@torch.no_grad()
def prefill_chunk_step(model: EncDecLM, tokens: torch.Tensor, cache: Cache,
                       cfg: ModelConfig, n_active: torch.Tensor
                       ) -> Tuple[torch.Tensor, Cache]:
    """Decoder-side chunked prefill: a C-token slab of prompt tokens per
    slot into the self-attention cache, cross-attending the static
    ``cross_k``/``cross_v``.  The contract of ``lm.prefill_chunk_step``:
    tokens (B, C), n_active (B,); returns (logits (B, C, V), the cache with
    lengths advanced by n_active)."""
    dtype = cfg.torch_dtype()
    c = tokens.shape[1]
    lengths = cache["length"]
    active = (torch.arange(c, dtype=torch.int32, device=tokens.device)[None, :]
              < n_active[:, None])
    x = embed(model.embed, tokens, dtype)
    s_max = cache["k"].shape[2]
    for layer, k_c, v_c, ck, cv in zip(model.dec_layers, cache["k"],
                                       cache["v"], cache["cross_k"],
                                       cache["cross_v"]):
        h = rms_norm(x, layer.norm_self, cfg.norm_eps)
        x = x + attn.attention_prefill_chunk(layer.self_attn, h, k_c, v_c,
                                             s_max, lengths, active, cfg)
        h = rms_norm(x, layer.norm_cross, cfg.norm_eps)
        x = x + attn.attention_prefill_chunk(layer.cross_attn, h, ck, cv,
                                             ck.shape[1], lengths, active,
                                             cfg, rope=False, cross=True)
        x = x + mlp(layer.mlp, rms_norm(x, layer.norm_mlp, cfg.norm_eps),
                    dtype)
    cache["length"] = lengths + n_active
    return model.logits(x, cfg), cache


@torch.no_grad()
def decode_step(model: EncDecLM, token: torch.Tensor, cache: Cache,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """token: (B, 1) int32 → (logits (B, 1, V), the cache with the self K/V
    appended in place and every length advanced by one; a 0-d length stays
    0-d)."""
    dtype = cfg.torch_dtype()
    x = embed(model.embed, token, dtype)
    length = cache["length"]
    s_max = cache["k"].shape[2]
    for layer, k_c, v_c, ck, cv in zip(model.dec_layers, cache["k"],
                                       cache["v"], cache["cross_k"],
                                       cache["cross_v"]):
        h = rms_norm(x, layer.norm_self, cfg.norm_eps)
        x = x + attn.attention_decode(layer.self_attn, h, k_c, v_c, s_max,
                                      length, cfg)
        h = rms_norm(x, layer.norm_cross, cfg.norm_eps)
        x = x + attn.attention_decode(layer.cross_attn, h, ck, cv,
                                      ck.shape[1], length, cfg, rope=False,
                                      cross=True)
        x = x + mlp(layer.mlp, rms_norm(x, layer.norm_mlp, cfg.norm_eps),
                    dtype)
    cache["length"] = length + 1
    return model.logits(x, cfg), cache
