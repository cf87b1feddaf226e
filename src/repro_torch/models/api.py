"""Model API for the training step, the serving engine, the one-shot
prefill and lockstep decode, over every layout of the JAX package's
``models/api.py`` (dense, MoE, RWKV6, Mamba2-hybrid and encoder-decoder):

    param_shapes(cfg)                       the JAX-named tree, meta tensors
    init_params(cfg, seed, device)          initialized model
    forward(model, batch, cfg)              full-sequence logits + MoE aux
    loss_fn(model, batch, cfg)              chunked-CE loss (+ MoE aux)
    prefill(model, batch, cfg)              last-position logits, no cache
    init_cache(cfg, batch, max_len, device) decode cache
    cache_shapes(cfg, batch, max_len)       the decode cache, meta tensors
    serve_step(model, token, cache, cfg)    one-token decode
    prefill_chunk(model, toks, cache, …)    C-token prompt slab into the cache
    splice_prefix(cache, slot, k, v)        prompt-prefix KV into a slot
    supports_chunked_prefill(cfg)           which layouts take the chunked path

``batch`` is a dict with ``tokens`` (B, S) int32 (and ``labels`` for
``loss_fn``), plus ``frames`` (B,
n_frames, d) for the encoder-decoder and, optionally,
``frontend_embeddings`` (B, n_front, d) prepended for a decoder-only vlm.
``device=None`` means the card (``device.resolve_device``); pass
``device="cpu"`` for the CPU.  ``lm`` hands the encdec layout to
``models/encdec.py``; ``forward`` and ``prefill`` do it here.  The
recurrent layouts (rwkv, mamba_hybrid) and windowed caches (ring buffers:
dense sliding-window and local:global stacks deeper than their window)
serve prompts token-wise through ``serve_step``; ``prefill_chunk`` and
``splice_prefix`` need the full-depth positional KV cache of the dense,
MoE and encdec layouts (for encdec the decoder's self K/V; cross K/V are
per request).  The serving entry points run without autograd; ``loss_fn``
records a graph where the parameters require grad (``train/step.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention, convert, encdec, lm
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import Cache, DecoderLM, ForwardOut

Batch = Dict[str, Any]


def param_shapes(cfg: ModelConfig) -> dict:
    """The JAX package's parameter tree for ``cfg`` — its key paths, the
    layer axis stacked — as meta tensors of each leaf's shape and dtype
    (the reference's ShapeDtypeStruct tree)."""
    model = (encdec.EncDecLM if cfg.layout == "encdec"
             else lm.DecoderLM)(cfg, torch.device("meta"))
    return convert.params_to_jax(model, cfg)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> DecoderLM:
    return lm.init_lm(cfg, seed, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Cache:
    return lm.init_cache(cfg, batch, max_len, device)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Cache:
    """The decode cache as meta tensors — the JAX package's
    ``cache_shapes`` tree (its keys, shapes and dtypes)."""
    return lm.init_cache(cfg, batch, max_len, torch.device("meta"))


def _hidden(model: DecoderLM, batch: Batch, cfg: ModelConfig):
    if cfg.layout == "encdec":
        return encdec.forward_hidden(model, batch["frames"], batch["tokens"],
                                     cfg)
    return lm.forward_hidden(model, batch["tokens"], cfg,
                             batch.get("frontend_embeddings"))


@torch.no_grad()
def forward(model: DecoderLM, batch: Batch, cfg: ModelConfig) -> ForwardOut:
    """Full-sequence logits (B, S, V) and the MoE aux loss (S counts a
    decoder-only model's frontend positions)."""
    hidden, aux = _hidden(model, batch, cfg)
    return ForwardOut(model.head(hidden, cfg), aux)


def _chunk_ce(model: DecoderLM, cfg: ModelConfig, x: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp − gold logit) over one (B, c) chunk, logits in fp32."""
    logits = model.head(x, cfg).float()
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def chunked_cross_entropy(x: torch.Tensor, model: DecoderLM,
                          labels: torch.Tensor, cfg: ModelConfig,
                          chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy from final-normed hiddens x (B, S, d)
    against labels (B, S), the sequence cut into the reference's chunks
    (S // chunk of them, one when that does not divide S).  At most one
    chunk's (B, chunk, V) fp32 logits are live: under autograd each chunk
    is recomputed in the backward pass (``torch.utils.checkpoint``), where
    the reference's ``lax.scan`` would otherwise keep every chunk's."""
    b, s, _ = x.shape
    n = max(s // chunk, 1)
    if s % n:
        n = 1
    c = s // n
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        xb, yb = x[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c]
        if torch.is_grad_enabled():
            part = checkpoint(_chunk_ce, model, cfg, xb, yb,
                              use_reentrant=False)
        else:
            part = _chunk_ce(model, cfg, xb, yb)
        total = total + part
    return total / (b * s)


def loss_fn(model: DecoderLM, batch: Batch, cfg: ModelConfig,
            aux_weight: float = 0.01, loss_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE (labels aligned with tokens) + ``aux_weight`` x the
    MoE aux loss: (loss, {"ce", "aux"}).  A decoder-only model's frontend
    positions are dropped before the loss."""
    labels = batch["labels"]
    hidden, aux = _hidden(model, batch, cfg)
    ce = chunked_cross_entropy(hidden[:, -labels.shape[1]:], model, labels,
                               cfg, chunk=loss_chunk)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill(model: DecoderLM, batch: Batch, cfg: ModelConfig) -> torch.Tensor:
    """Next-token logits for the *last* position only (B, V): the one-shot
    prefill recomputes the whole prompt and fills no cache (the serving
    engine uses ``prefill_chunk``, which fills the decode cache)."""
    hidden, _ = _hidden(model, batch, cfg)
    return model.head(hidden[:, -1:], cfg)[:, 0]


@torch.no_grad()
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
    decode slot, in place, and set the slot's length to P (for encdec the
    decoder's self K/V only; cross K/V are per request)."""
    attention.splice_kv(cache["k"], cache["v"], slot, k_block, v_block)
    cache["length"][slot] = k_block.shape[1]
    return cache


@torch.no_grad()
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
