"""GreenCache: cross-query reuse for the GreenServ serving stack.

The cheapest token is the one never computed.  Two cooperating layers cut
engine work before routing ever sees a query:

  * **Prefix-KV reuse** (``prefix``/``kvpool``) — a per-engine radix trie
    over completed prompts backed by a bounded host-side KV block pool
    (CPU tensors in the engine's dtype); on admission the longest cached
    prefix is spliced into the decode slot's cache on the card
    (``models/api.splice_prefix``) and the engine prefill-chunks only the
    uncached suffix.
  * **Semantic response cache** (``semantic``) — embedding-similarity
    lookup (cosine + task-type/cluster guards) that answers exact or
    near-duplicate queries with the cached completion, zero engine work.

``GreenCache`` is the facade ``PoolServer`` holds: it owns the semantic
cache, creates per-engine prefix caches on demand, and (once bound to the
router's ``ContextGenerator``) computes the guard features with the same
embedder/classifier/centroids the router uses — read-only, so cache
probes never perturb routing state (no k-means updates, no classifier
fits).  Every hit is credited as avoided energy to telemetry
(``greenserv_energy_joules_avoided_total{kind=prefix|semantic}``) and the
governor's credit ledger: a prefix hit through its engine's meter
(``cumulative_joules_avoided``, diffed each step), a semantic hit by the
scheduler (``Telemetry.on_cache_hit``); see ``docs/CACHING.md``.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.cache.kvpool import KVBlockPool
from repro_torch.cache.prefix import PrefixCache, PrefixIndex
from repro_torch.cache.semantic import SemanticCache, SemanticEntry

CACHE_MODES = ("off", "prefix", "semantic", "full")


class GreenCache:
    """Facade over the prefix-KV and semantic layers.

    ``mode`` selects which layers are live: ``off`` (inert — convenient
    for flag plumbing), ``prefix``, ``semantic``, or ``full`` (both).
    ``kv_cache_blocks``/``block_tokens`` size each per-engine KV pool;
    ``semantic_threshold``/``semantic_entries``/``semantic_ttl_s``
    parameterize the response cache (``semantic_ttl_s``: max entry age in
    seconds before a cached answer ages out; ``clock`` supplies the time
    source — pass a virtual clock in simulation, default is monotonic
    wall time).
    """

    def __init__(self, mode: str = "full", kv_cache_blocks: int = 256,
                 block_tokens: int = 8, semantic_threshold: float = 0.92,
                 semantic_entries: int = 512, cluster_guard: bool = True,
                 semantic_ttl_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        if mode not in CACHE_MODES:
            raise ValueError(f"mode must be one of {CACHE_MODES}, got {mode!r}")
        self.mode = mode
        self.kv_cache_blocks = kv_cache_blocks
        self.block_tokens = block_tokens
        self.semantic: Optional[SemanticCache] = None
        if mode in ("semantic", "full"):
            self.semantic = SemanticCache(threshold=semantic_threshold,
                                          max_entries=semantic_entries,
                                          cluster_guard=cluster_guard,
                                          ttl_s=semantic_ttl_s, clock=clock)
        self._prefix: Dict[str, PrefixCache] = {}
        self._context = None            # router's ContextGenerator, read-only

    # -- layer gates ---------------------------------------------------------

    @property
    def prefix_enabled(self) -> bool:
        return self.mode in ("prefix", "full")

    @property
    def semantic_enabled(self) -> bool:
        return self.semantic is not None

    def prefix_for(self, engine_name: str) -> Optional[PrefixCache]:
        """The engine's own prefix cache (KV is parameter-specific), or
        None when prefix reuse is off."""
        if not self.prefix_enabled:
            return None
        cache = self._prefix.get(engine_name)
        if cache is None:
            cache = self._prefix[engine_name] = PrefixCache(
                max_blocks=self.kv_cache_blocks,
                block_tokens=self.block_tokens)
        return cache

    # -- guard features (shared with the router, read-only) -------------------

    def bind_context(self, context) -> None:
        """Share the router's ContextGenerator for guard features.  The
        semantic cache must see the *same* embedding space and task labels
        the router routes by — a private embedder would let a hit fire on
        a pair the router considers unrelated."""
        self._context = context
        if (self.semantic is not None and len(self.semantic) == 0
                and self.semantic._emb.shape[1] != context.embedder.dim):
            # re-key an EMPTY cache to the embedder's dimensionality;
            # a populated cache keeps its space (entries would be orphaned)
            self.semantic._emb = np.zeros(
                (self.semantic.max_entries, context.embedder.dim), np.float32)

    def features(self, text: str) -> Tuple[int, int, np.ndarray]:
        """(task_label, cluster, unit embedding) for one query — read-only
        probes of the bound context (``predict``/``assign`` mutate
        nothing; k-means updates stay exclusive to ``route_batch``)."""
        if self._context is None:
            raise RuntimeError("GreenCache.features before bind_context")
        ctx = self._context
        emb = ctx.embedder.encode(text)
        task = (int(ctx.task_classifier.predict(text)) if ctx.use_task else 0)
        cluster = (ctx.kmeans.assign(emb) if ctx.use_cluster else 0)
        return task, cluster, emb

    def features_batch(self, texts) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        """Batched ``features``: (labels (Q,), clusters (Q,), embeddings
        (Q, dim)) in one featurization pass via the bound context's
        read-only ``probe_batch`` — on the device path one featurize
        kernel launch whose embeddings the router reuses afterwards."""
        if self._context is None:
            raise RuntimeError("GreenCache.features_batch before bind_context")
        return self._context.probe_batch(texts)

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        out = {"mode": self.mode}
        if self.semantic is not None:
            out["semantic"] = self.semantic.stats()
        if self._prefix:
            out["prefix"] = {name: pc.stats()
                             for name, pc in sorted(self._prefix.items())}
        return out


__all__ = ["CACHE_MODES", "GreenCache", "KVBlockPool", "PrefixCache",
           "PrefixIndex", "SemanticCache", "SemanticEntry"]
