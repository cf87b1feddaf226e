"""GQA attention: one-shot prefill over a whole sequence, chunked prefill
against a decode cache, single-token decode over a full-depth KV cache,
and single-token decode over a ring buffer the size of the window.

One code path serves full, sliding-window and local:global attention —
the per-layer ``window`` scalar parameterizes the mask (window == sequence
or cache depth ⇒ full causal attention).  Scores and softmax run in
float32 with K/V read from their storage dtype.  One-shot prefill attends
through the flash-attention kernel under ``cfg.use_pallas`` and through
the blocked ``flash_prefill`` otherwise.  Decode takes a cache length that
is a (B,) vector (per-slot lengths: the serving engine) or a 0-d tensor
(every row in lockstep: the model API's ``serve_step``); with a 0-d length
a full-depth cache of S ≥ 2048 under ``cfg.use_pallas`` attends through
the decode-attention kernel, as in the JAX package.  The cache writes
happen in place: the JAX package threads the cache through ``jit`` with
donated buffers, which is the same single copy updated where it lies.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, param

# most-negative bf16-representable value, never -inf: a row with nothing
# visible (an idle padding slot) then softmaxes to finite garbage, not NaN
NEG_INF = -2.3819763e38


class Attention(nn.Module):
    """Projections in the JAX layout: wq (d, Hq, hd), wk/wv (d, Hk, hd),
    wo (Hq, hd, d)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        d, hq, hk, hd = (cfg.d_model, cfg.compute_heads, cfg.n_kv_heads,
                         cfg.head_dim)
        dt = cfg.torch_param_dtype()
        self.wq = param((d, hq, hd), dt, device)
        self.wk = param((d, hk, hd), dt, device)
        self.wv = param((d, hk, hd), dt, device)
        self.wo = param((hq, hd, d), dt, device)


def project_q(params: Attention, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, rope: bool = True) -> torch.Tensor:
    """The query projection alone: cross-attention reads its K/V from the
    encoder side, so it projects no K/V of its own (the JAX package
    projects them and XLA drops the unused products)."""
    q = torch.einsum("bsd,dhk->bshk", x, params.wq.to(cfg.torch_dtype()))
    return apply_rope(q, positions, cfg.rope_theta) if rope else q


def project_qkv(params: Attention, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, rope: bool = True):
    dt = cfg.torch_dtype()
    q = project_q(params, x, positions, cfg, rope=rope)
    k = torch.einsum("bsd,dhk->bshk", x, params.wk.to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, params.wv.to(dt))
    if rope:
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(NEG_INF, dtype=torch.float32, device=like.device)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int, chunk: int, causal: bool = True) -> torch.Tensor:
    """The JAX package's blocked jnp prefill attention.

    q: (B, Sq, Hq, hd); k, v: (B, Sk, Hk, hd) → (B, Sq, Hq, hd).  Query i
    sees key j where j > i - ``window`` and, when ``causal``, j <= i (the
    encoder-decoder's encoder and cross-attention run it non-causal, the
    window still counted from the query's position).  The keys
    are cut into the reference's blocks (Sk // chunk of them, or one block
    when that does not divide Sk) and visited in order with an fp32 online
    softmax.  Unlike the flash kernel, scores are scaled after the q·k
    product and masked pairs are not zeroed in p (a row's fully masked
    leading blocks are erased by the correction factor once a visible key
    arrives).  The reference also blocks the queries; every query row is
    independent, so all rows go through each key block at once here.
    """
    b, sq, hq, hd = q.shape
    sk, hk = k.shape[1], k.shape[2]
    group = hq // hk
    scale = hd ** -0.5
    n_k = max(sk // chunk, 1)
    if sk % n_k:
        n_k = 1
    k_chunk = sk // n_k
    qf = q.reshape(b, sq, hk, group, hd).float()
    q_pos = torch.arange(sq, device=q.device)
    neg_inf = _neg_inf(qf)
    acc = torch.zeros((b, hk, group, sq, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, hk, group, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for ki in range(n_k):
        k_tile = k[:, ki * k_chunk:(ki + 1) * k_chunk].float()
        v_tile = v[:, ki * k_chunk:(ki + 1) * k_chunk].float()
        k_pos = ki * k_chunk + torch.arange(k_chunk, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k_tile) * scale
        mask = k_pos[None, :] > q_pos[:, None] - window
        if causal:
            mask &= k_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask, s, neg_inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   v_tile)
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)


def lengths_vec(cache_len: torch.Tensor, b: int) -> torch.Tensor:
    """Cache lengths as (B,) int32: a 0-d length is broadcast (lockstep
    ``serve_step``), per-slot vectors pass through (continuous-batching
    engine)."""
    cl = cache_len.to(torch.int32)
    return cl.expand(b) if cl.ndim == 0 else cl


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, window: int,
                  cache_len: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, Hq, hd); caches: (B, S, Hk, hd); ``cache_len`` 0-d or
    (B,): slot b attends to positions [cache_len_b - window,
    cache_len_b).  Scores accumulate in float32."""
    b, _, hq, hd = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    group = hq // hk
    scale = hd ** -0.5
    q4 = q.reshape(b, hk, group, hd).float()
    scores = torch.einsum("bhgd,bshd->bhgs", q4, k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)
    cl = lengths_vec(cache_len, b)[:, None]                    # (B, 1)
    valid = (pos[None] < cl) & (pos[None] >= cl - window)      # (B, S)
    scores = torch.where(valid[:, None, None, :], scores, _neg_inf(scores))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def chunk_attend(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, window: int,
                 positions: torch.Tensor) -> torch.Tensor:
    """Multi-query generalization of ``decode_attend``: a slab of C new
    tokens attends into a full-depth cache.

    q: (B, C, Hq, hd); caches: (B, S, Hk, hd); positions: (B, C) absolute
    position of each query token, so slot b's query c attends to cache
    positions (positions[b,c] - window, positions[b,c]].  Within a chunk,
    earlier chunk tokens are visible to later ones because their K/V were
    written into the cache *before* this attend.  A row whose mask is
    empty (inactive padding slot) degrades to a uniform softmax over
    NEG_INF scores — finite garbage the caller discards, never NaN.
    """
    b, c, hq, hd = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    group = hq // hk
    scale = hd ** -0.5
    q5 = q.reshape(b, c, hk, group, hd).float()
    scores = torch.einsum("bchgd,bshd->bhgcs", q5, k_cache.float()) * scale
    pos = torch.arange(s, dtype=torch.int32, device=q.device)
    valid = ((pos[None, None] <= positions[:, :, None])
             & (pos[None, None] > positions[:, :, None] - window))  # (B, C, S)
    scores = torch.where(valid[:, None, None], scores, _neg_inf(scores))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgcs,bshd->bchgd", p, v_cache.float())
    return out.reshape(b, c, hq, hd).to(q.dtype)


def write_chunk_(cache: torch.Tensor, new: torch.Tensor,
                 lengths: torch.Tensor, active: torch.Tensor) -> None:
    """Write a (B, C, Hk, hd) slab into a (B, S, Hk, hd) cache at per-slot
    offsets ``lengths``, in place.  Position s of slot b takes slab entry
    c = s − lengths[b] when 0 ≤ c < C and ``active[b, c]``; every other
    position — inactive padding, and slab entries past the cache end —
    writes nothing."""
    b, c = active.shape
    s = cache.shape[1]
    c_idx = (torch.arange(s, device=cache.device)[None, :]
             - lengths[:, None].long())                          # (B, S)
    c_cl = c_idx.clamp(0, c - 1)
    touched = (c_idx >= 0) & (c_idx < c) & torch.gather(active, 1, c_cl)
    picked = torch.gather(
        new, 1, c_cl[:, :, None, None].expand(b, s, *new.shape[2:]))
    cache.copy_(torch.where(touched[:, :, None, None],
                            picked.to(cache.dtype), cache))


def attention_prefill_chunk(params: Attention, x: torch.Tensor,
                            k_cache: torch.Tensor, v_cache: torch.Tensor,
                            window: int, lengths: torch.Tensor,
                            active: torch.Tensor, cfg: ModelConfig,
                            rope: bool = True,
                            cross: bool = False) -> torch.Tensor:
    """One attention layer over a C-token prompt slab at per-slot offsets.

    x: (B, C, d) slab activations; ``lengths``: (B,) tokens already in the
    cache per slot (the slab lands at positions lengths..lengths+C-1);
    ``active``: (B, C) bool — position c is a real token iff
    c < n_active[b].  Self-attention writes the slab's K/V into the caches
    in place first (inactive positions write nothing), then the slab
    attends write-then-read, so intra-chunk causality comes from the
    position mask alone.  Cross-attention (``cross``) reads the static
    encoder-side caches, every position visible to every query token, and
    writes nothing.  Returns out (B, C, d).
    """
    dt = cfg.torch_dtype()
    c = x.shape[1]
    offs = torch.arange(c, dtype=torch.int32, device=x.device)
    positions = lengths[:, None] + offs[None, :]                 # (B, C)
    if cross:
        q = project_q(params, x, positions, cfg, rope=rope)
        n_f = k_cache.shape[1]
        out = chunk_attend(q, k_cache, v_cache, n_f,
                           torch.full_like(positions, n_f - 1))
    else:
        q, k_new, v_new = project_qkv(params, x, positions, cfg, rope=rope)
        write_chunk_(k_cache, k_new, lengths, active)
        write_chunk_(v_cache, v_new, lengths, active)
        out = chunk_attend(q, k_cache, v_cache, window, positions)
    return torch.einsum("bshk,hkd->bsd", out, params.wo.to(dt))


def attention_prefill(params: Attention, x: torch.Tensor,
                      positions: torch.Tensor, window: int, cfg: ModelConfig,
                      rope: bool = True,
                      kv_override: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None
                      ) -> torch.Tensor:
    """One attention layer over a whole sequence (one-shot prefill): x
    (B, S, d), positions (B, S) → out (B, S, d).  Causal self-attention,
    or with ``kv_override`` (encoder-side K/V) non-causal attention to
    those keys.  Attends through the flash-attention kernel's wrapper
    under ``cfg.use_pallas``, else through ``flash_prefill``."""
    dt = cfg.torch_dtype()
    if kv_override is None:
        q, k, v = project_qkv(params, x, positions, cfg, rope=rope)
    else:
        q = project_q(params, x, positions, cfg, rope=rope)
        k, v = kv_override
    causal = kv_override is None
    if cfg.use_pallas:
        out = fa_ops.flash_attention(q, k, v, window, causal)
    else:
        out = flash_prefill(q, k, v, window, cfg.attn_chunk, causal)
    return torch.einsum("bshk,hkd->bsd", out, params.wo.to(dt))


def attention_decode(params: Attention, x: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     window: int, cache_len: torch.Tensor,
                     cfg: ModelConfig, rope: bool = True,
                     cross: bool = False) -> torch.Tensor:
    """x: (B, 1, d); ``cache_len`` (B,) per-slot lengths or 0-d (every row
    at the same length).  Appends the new K/V in place, then attends.
    Returns out (B, 1, d).  Cross-attention (``cross``) writes nothing and
    attends to every entry of the static encoder-side caches, never
    through the decode kernel.

    The append, as the JAX package makes it: a masked ``where`` when
    ``cfg.kv_update == "where"`` or the length is a vector (a slot already
    at the cache end writes nothing); otherwise the
    ``dynamic_update_slice`` append, whose start index is clamped to
    [0, S - 1] (at length == S it overwrites position S - 1).  With a 0-d
    length, ``cfg.use_pallas`` and a cache of S ≥ 2048 the attention runs
    through the decode-attention kernel, else through ``decode_attend``.
    """
    dt = cfg.torch_dtype()
    s = k_cache.shape[1]
    lockstep = cache_len.ndim == 0
    lengths = lengths_vec(cache_len, x.shape[0])
    if cross:
        q = project_q(params, x, lengths[:, None], cfg, rope=rope)
        out = decode_attend(q, k_cache, v_cache, window,
                            torch.full_like(lengths, s))
        return torch.einsum("bshk,hkd->bsd", out, params.wo.to(dt))
    q, k_new, v_new = project_qkv(params, x, lengths[:, None], cfg, rope=rope)
    if cfg.kv_update == "where" or not lockstep:
        sel = (torch.arange(s, device=x.device)[None]
               == lengths[:, None])[:, :, None, None]
        k_cache.copy_(torch.where(sel, k_new.to(k_cache.dtype), k_cache))
        v_cache.copy_(torch.where(sel, v_new.to(v_cache.dtype), v_cache))
    else:
        start = cache_len.clamp(0, s - 1).reshape(1).long()
        k_cache.index_copy_(1, start, k_new.to(k_cache.dtype))
        v_cache.index_copy_(1, start, v_new.to(v_cache.dtype))
    if cfg.use_pallas and s >= 2048 and lockstep:
        out = da_ops.decode_attention(q, k_cache, v_cache, window,
                                      cache_len + 1)
    else:
        out = decode_attend(q, k_cache, v_cache, window, lengths + 1)
    return torch.einsum("bshk,hkd->bsd", out, params.wo.to(dt))


def attention_decode_ring(params: Attention, x: torch.Tensor,
                          k_ring: torch.Tensor, v_ring: torch.Tensor,
                          cache_len: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    """Sliding-window decode against a ring buffer of W = the window: x
    (B, 1, d); rings (B, W, Hk, hd); ``cache_len`` (B,) or 0-d.  The new
    K/V land in slot length % W of each row, in place, then the row
    attends to the live entries.  Returns out (B, 1, d).  This layout makes
    gemma3-12b's 40 local layers hold 1,024 entries each instead of the
    full cache depth."""
    dt = cfg.torch_dtype()
    b = x.shape[0]
    lengths = lengths_vec(cache_len, b)
    q, k_new, v_new = project_qkv(params, x, lengths[:, None], cfg)
    w = k_ring.shape[1]
    rows = torch.arange(b, device=x.device)
    slot = (lengths % w).long()
    k_ring[rows, slot] = k_new[:, 0].to(k_ring.dtype)
    v_ring[rows, slot] = v_new[:, 0].to(v_ring.dtype)
    # the ring is the window: entry i is live iff i < min(length + 1, W),
    # which is decode_attend's mask at cache_len min(length + 1, W) and
    # window W; softmax does not care about ring order (RoPE was applied
    # at write time)
    out = decode_attend(q, k_ring, v_ring, w, (lengths + 1).clamp(max=w))
    return torch.einsum("bshk,hkd->bsd", out, params.wo.to(dt))


def splice_kv(k_cache: torch.Tensor, v_cache: torch.Tensor, slot: int,
              k_block, v_block) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write a prompt-prefix KV block into one slot's cache rows in place.

    k_cache/v_cache: (L, B, S, Hk, hd) stacked per-layer caches;
    k_block/v_block: (L, P, Hk, hd) KV for prompt positions [0, P).  Every
    other slot's rows are untouched."""
    k_block = torch.as_tensor(k_block, device=k_cache.device)
    v_block = torch.as_tensor(v_block, device=v_cache.device)
    p = k_block.shape[1]
    k_cache[:, slot, :p] = k_block.to(k_cache.dtype)
    v_cache[:, slot, :p] = v_block.to(v_cache.dtype)
    return k_cache, v_cache
