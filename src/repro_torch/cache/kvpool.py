"""Bounded host-side KV block pool with LRU eviction.

The unit of storage is a *block*: ``block_tokens`` consecutive prompt
tokens' worth of per-layer K and V for one model — CPU tensors of shape
``(n_layers, block_tokens, kv_heads, head_dim)`` each, in the engine's
cache dtype (bf16 at full width: numpy has no bf16, and an fp32 copy
would double the pool's host memory).  Blocks live on the host (the
device-side slot cache is transient per request; the pool is what
survives across requests and engine restarts), so capacity is a
host-memory knob, not a device-memory one.

The pool itself is policy-free: it stores, hands out, frees, and keeps a
deterministic recency order (a monotonic operation counter, never wall
time).  *Which* block to evict is the index's decision — a radix/trie
index must keep chains contiguous, so it evicts least-recently-used
**leaves** (``repro_torch.cache.prefix.PrefixIndex``); the pool only
reports who is least recently used.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def _tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class KVBlockPool:
    """Bounded store of (k, v) host blocks keyed by integer block id.

    ``put`` refuses (returns ``None``) when full — the caller frees a
    victim first.  Recency is a monotonic counter bumped by ``touch``;
    ``lru_order`` is therefore deterministic for a deterministic call
    sequence (seeded workloads replay to identical eviction traces).
    """

    def __init__(self, max_blocks: int, block_tokens: int = 8):
        if max_blocks < 1:
            raise ValueError(f"max_blocks must be >= 1, got {max_blocks}")
        if block_tokens < 1:
            raise ValueError(f"block_tokens must be >= 1, got {block_tokens}")
        self.max_blocks = max_blocks
        self.block_tokens = block_tokens
        self._blocks: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._last_used: Dict[int, int] = {}
        self._next_id = 0
        self._tick = 0
        self.evictions = 0
        self.nbytes = 0

    # -- capacity ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._blocks)

    @property
    def full(self) -> bool:
        return len(self._blocks) >= self.max_blocks

    # -- storage -------------------------------------------------------------

    def put(self, k, v):
        """Store one block (tensors, or arrays taken as tensors); returns
        its id, or None when at capacity."""
        if self.full:
            return None
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        if k.shape[1] != self.block_tokens:
            raise ValueError(
                f"block must hold {self.block_tokens} tokens, got "
                f"{tuple(k.shape)}")
        bid = self._next_id
        self._next_id += 1
        self._blocks[bid] = (k, v)
        self.nbytes += _tensor_bytes(k) + _tensor_bytes(v)
        self.touch(bid)
        return bid

    def get(self, bid: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._blocks[bid]

    def free(self, bid: int) -> None:
        k, v = self._blocks.pop(bid)
        self.nbytes -= _tensor_bytes(k) + _tensor_bytes(v)
        self._last_used.pop(bid, None)
        self.evictions += 1

    def touch(self, bid: int) -> None:
        """Bump recency (monotonic op counter — replayable, no wall time)."""
        self._tick += 1
        self._last_used[bid] = self._tick

    def lru_order(self) -> List[int]:
        """Block ids, least recently used first."""
        return sorted(self._last_used, key=self._last_used.get)

    def stats(self) -> dict:
        return {"blocks": len(self._blocks), "max_blocks": self.max_blocks,
                "block_tokens": self.block_tokens, "nbytes": self.nbytes,
                "evictions": self.evictions}
