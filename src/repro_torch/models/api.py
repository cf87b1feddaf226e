"""Model API for the serving engine, the one-shot prefill and lockstep
decode (the dense, MoE, RWKV6 and Mamba2-hybrid subset of the JAX
package's ``models/api.py``):

    init_params(cfg, seed, device)          initialized model
    forward(model, batch, cfg)              full-sequence logits + MoE aux
    prefill(model, batch, cfg)              last-position logits, no cache
    init_cache(cfg, batch, max_len, device) decode cache
    serve_step(model, token, cache, cfg)    one-token decode
    prefill_chunk(model, toks, cache, …)    C-token prompt slab into the cache
    splice_prefix(cache, slot, k, v)        prompt-prefix KV into a slot
    supports_chunked_prefill(cfg)           which layouts take the chunked path

``batch`` is a dict with ``tokens`` (B, S) int32.  ``device=None`` means
the card (``device.resolve_device``); pass ``device="cpu"`` for the CPU.
The recurrent layouts (rwkv, mamba_hybrid) and windowed caches (ring
buffers: dense sliding-window and local:global stacks deeper than their
window) serve prompts token-wise through ``serve_step``;
``prefill_chunk`` and ``splice_prefix`` need the full-depth positional KV
cache of the dense and MoE layouts.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import attention, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Cache, DecoderLM, ForwardOut

Batch = Dict[str, Any]


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> DecoderLM:
    return lm.init_lm(cfg, seed, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Cache:
    return lm.init_cache(cfg, batch, max_len, device)


def forward(model: DecoderLM, batch: Batch, cfg: ModelConfig) -> ForwardOut:
    """Full-sequence logits (B, S, V) and the MoE aux loss."""
    return lm.forward(model, batch["tokens"], cfg)


def prefill(model: DecoderLM, batch: Batch, cfg: ModelConfig) -> torch.Tensor:
    """Next-token logits for the *last* position only (B, V): the one-shot
    prefill recomputes the whole prompt and fills no cache (the serving
    engine uses ``prefill_chunk``, which fills the decode cache)."""
    hidden, _ = lm.forward_hidden(model, batch["tokens"], cfg)
    return model.head(hidden[:, -1:], cfg)[:, 0]


def serve_step(model: DecoderLM, token: torch.Tensor, cache: Cache,
               cfg: ModelConfig) -> Tuple[torch.Tensor, Cache]:
    """One new token against the cache: (logits (B,1,V), cache).

    ``cache["length"]`` is either (B,) — per-slot lengths, as the serving
    engine keeps them — or a 0-d tensor, every row at the same length
    (lockstep decode, the JAX package's dry-run ``serve_step``); a 0-d
    length comes back 0-d.  Only a 0-d length sends the full-depth caches
    of S ≥ 2048 through the decode-attention kernel under
    ``cfg.use_pallas`` (per-slot lengths attend through the plain
    ``decode_attend``, as in the JAX package)."""
    return lm.decode_step(model, token, cache, cfg)


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Whether ``prefill_chunk`` exists for this architecture family: the
    attention-cached layouts whose decode cache is a full-depth positional
    KV store (recurrent layouts keep the one-token path)."""
    return cfg.layout in ("dense", "moe", "encdec")


def splice_prefix(cache: Cache, slot: int, k_block, v_block) -> Cache:
    """Splice a prompt-prefix KV block ((L, P, Hk, hd) each) into one
    decode slot, in place, and set the slot's length to P."""
    attention.splice_kv(cache["k"], cache["v"], slot, k_block, v_block)
    cache["length"][slot] = k_block.shape[1]
    return cache


def prefill_chunk(model: DecoderLM, tokens: torch.Tensor, cache: Cache,
                  cfg: ModelConfig, n_active: torch.Tensor
                  ) -> Tuple[torch.Tensor, Cache]:
    """Populate the decode cache with a (B, C) slab of prompt tokens at
    per-slot offsets ``cache["length"]``; ``n_active`` (B,) gates how many
    of the C positions are real per slot (0 = idle slot this step).

    Returns (logits (B, C, V), cache).  The logits at position
    n_active[b]-1 are the next-token logits slot b would have produced by
    feeding the same tokens one at a time through ``serve_step``.
    """
    return lm.prefill_chunk_step(model, tokens, cache, cfg, n_active)
