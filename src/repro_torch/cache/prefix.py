"""Prefix-KV reuse: a token-level radix trie over completed prompts.

Per-slot decode caches are absolute-positioned from 0
(``models/lm.py``): the K/V written for prompt
position ``i`` depends only on tokens ``0..i`` (causal attention, RoPE by
absolute position).  Two prompts sharing a token prefix therefore produce
**identical** KV for the shared region, so a completed prompt's KV can be
captured once and spliced into any later slot whose prompt starts with the
same tokens — the engine then prefill-chunks only the uncached suffix
(GreenServ's cheapest token: the one never computed).

Structure: a trie whose edges are whole ``block_tokens``-token blocks
(radix over token tuples, vLLM-style).  Each node owns exactly one block
in a bounded :class:`~repro_torch.cache.kvpool.KVBlockPool`; a lookup walks
whole-block matches from the root, so hits are block-aligned and the
chain root→node is always contiguous.  Eviction removes the
least-recently-used **leaf** (interior nodes anchor live chains), which
keeps every remaining chain usable and makes eviction deterministic for a
seeded workload.

Partial tail blocks are not cached: the capture path rounds the prompt
down to whole blocks (a short tail is cheap to recompute and would
fragment the index).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.cache.kvpool import KVBlockPool


class _Node:
    __slots__ = ("key", "parent", "children", "bid")

    def __init__(self, key: Tuple[int, ...], parent: Optional["_Node"],
                 bid: Optional[int]):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.bid = bid


class PrefixIndex:
    """Block-granular radix trie mapping token prefixes to pooled KV."""

    def __init__(self, pool: KVBlockPool):
        self.pool = pool
        self.root = _Node((), None, None)
        self._node_by_bid: Dict[int, _Node] = {}
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.inserted_blocks = 0

    def _walk(self, tokens: Sequence[int], touch: bool) -> List[_Node]:
        """Longest chain of whole-block matches from the root."""
        bt = self.pool.block_tokens
        node, chain = self.root, []
        for i in range(0, (len(tokens) // bt) * bt, bt):
            child = node.children.get(tuple(tokens[i:i + bt]))
            if child is None:
                break
            if touch:
                self.pool.touch(child.bid)
            chain.append(child)
            node = child
        return chain

    # -- queries -------------------------------------------------------------

    def peek_len(self, tokens: Sequence[int]) -> int:
        """Longest cached prefix in tokens, **without** bumping recency —
        for routing-time probes that may not materialize into a hit."""
        return len(self._walk(tokens, touch=False)) * self.pool.block_tokens

    def lookup(self, tokens: Sequence[int]
               ) -> Tuple[int, List[Tuple[torch.Tensor, torch.Tensor]]]:
        """Longest cached prefix: (n_tokens, [(k, v) blocks, root-first]).

        Matched blocks are LRU-touched (a used chain stays warm)."""
        self.lookups += 1
        chain = self._walk(tokens, touch=True)
        if not chain:
            return 0, []
        self.hits += 1
        n = len(chain) * self.pool.block_tokens
        self.hit_tokens += n
        return n, [self.pool.get(node.bid) for node in chain]

    # -- growth / eviction ---------------------------------------------------

    def insert(self, tokens: Sequence[int], k, v) -> int:
        """Register a completed prompt's KV; returns blocks newly stored.

        ``k``/``v``: host tensors ``(n_layers, P, kv_heads, head_dim)``
        covering at least the whole-block span of ``tokens``.  Existing
        nodes on the path are only recency-bumped (dedup); new nodes are
        allocated, evicting LRU leaves when the pool is at capacity.  If
        every pooled block is an ancestor on the current path (pool far
        smaller than one prompt), insertion stops rather than evicting
        its own chain.
        """
        bt = self.pool.block_tokens
        k, v = torch.as_tensor(k), torch.as_tensor(v)
        node, added = self.root, 0
        on_path = set()
        # never index tokens the arrays don't cover (defense in depth —
        # the engine already skips overflowed prompts)
        span = min(len(tokens), k.shape[1], v.shape[1])
        for i in range(0, (span // bt) * bt, bt):
            key = tuple(tokens[i:i + bt])
            child = node.children.get(key)
            if child is None:
                while self.pool.full:
                    if not self._evict_leaf(protect=on_path):
                        return added
                # a copy of its own: a view would keep the whole
                # prompt's capture alive for as long as the block lives
                bid = self.pool.put(k[:, i:i + bt].clone(),
                                    v[:, i:i + bt].clone())
                child = _Node(key, node, bid)
                node.children[key] = child
                self._node_by_bid[bid] = child
                self.inserted_blocks += 1
                added += 1
            else:
                self.pool.touch(child.bid)
            on_path.add(child.bid)
            node = child
        return added

    def _evict_leaf(self, protect: set) -> bool:
        """Drop the least-recently-used childless node; False if none."""
        for bid in self.pool.lru_order():
            node = self._node_by_bid[bid]
            if node.children or bid in protect:
                continue
            del node.parent.children[node.key]
            del self._node_by_bid[bid]
            self.pool.free(bid)
            return True
        return False

    def __len__(self) -> int:
        return len(self._node_by_bid)


class PrefixCache:
    """Per-engine facade: trie + pool + the match shape engines consume.

    One instance per engine (KV is parameter-specific); created by the
    ``GreenCache`` facade and attached via ``ModelEngine.set_prefix_cache``.
    """

    def __init__(self, max_blocks: int = 256, block_tokens: int = 8):
        self.pool = KVBlockPool(max_blocks, block_tokens)
        self.index = PrefixIndex(self.pool)

    @property
    def block_tokens(self) -> int:
        return self.pool.block_tokens

    def peek_len(self, tokens: Sequence[int],
                 max_tokens: Optional[int] = None) -> int:
        n = self.index.peek_len(tokens)
        return min(n, max_tokens) if max_tokens is not None else n

    def match(self, tokens: Sequence[int], max_tokens: int
              ) -> Tuple[int, Optional[torch.Tensor],
                         Optional[torch.Tensor]]:
        """Longest usable prefix for a prompt: (p, k, v) with k/v shaped
        ``(L, p, Hk, hd)``, or (0, None, None).  ``max_tokens`` caps the
        splice (an engine must keep >= 1 prompt token to feed, so it
        passes ``len(prompt) - 1``)."""
        if max_tokens <= 0:
            return 0, None, None
        n, blocks = self.index.lookup(tokens)
        p = min(n, max_tokens)
        if p <= 0:
            return 0, None, None
        k = torch.cat([b[0] for b in blocks], dim=1)[:, :p]
        v = torch.cat([b[1] for b in blocks], dim=1)[:, :p]
        return p, k, v

    def insert(self, tokens: Sequence[int], k, v) -> int:
        if len(tokens) < self.block_tokens:
            return 0
        return self.index.insert(tokens, k, v)

    def stats(self) -> dict:
        return {"lookups": self.index.lookups, "hits": self.index.hits,
                "hit_tokens": self.index.hit_tokens,
                "inserted_blocks": self.index.inserted_blocks,
                **self.pool.stats()}
