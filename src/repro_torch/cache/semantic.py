"""Semantic response cache: answer near-duplicate queries with zero engine
work.

Keys are the router's own hashed-n-gram sentence embeddings
(``core/embedding.py`` — unit vectors, so cosine similarity is one dot
product against the entry matrix).  A hit requires *all three* guards:

  * cosine(query, entry) >= ``threshold``;
  * same task type (a "summarize X" answer must never serve a "solve X"
    query, however close the vocabulary);
  * same semantic cluster, when cluster features are enabled (catches
    task-classifier confusions between topically distant duplicates).

Entries store the completed ``Response`` payload (tokens/text, the model
that produced it, its measured energy and accuracy) so the scheduler can
synthesize an answer without routing — the avoided energy is the cached
completion's own measured Wh, credited to telemetry/governor as
``kind="semantic"``.

This module is the JAX package's ``repro/cache/semantic.py`` (numpy only),
carried as its own copy.

Eviction is LRU over a fixed slot array with a monotonic op counter, so a
seeded workload replays to the same cache state.  An optional TTL
(``ttl_s``) ages entries out against an injectable clock — wall time in
live serving, a virtual clock in simulation — so a stale answer (a
"today's status" query, a since-updated document) stops being served once
it is older than the staleness budget.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np


@dataclasses.dataclass
class SemanticEntry:
    """One cached completion (the Response payload + its guard features)."""

    text: str                    # the query text that produced it
    task_label: int
    cluster: int
    model_name: str
    tokens: List[int]
    text_out: str
    energy_wh: float             # the original completion's measured energy
    accuracy: float
    input_tokens: int
    output_tokens: int


class SemanticCache:
    """Fixed-capacity embedding-similarity cache with task/cluster guards.

    Callers supply unit-norm embeddings (the ``GreenCache`` facade shares
    the router's ``EmbeddingModel`` so a query is embedded once).
    """

    def __init__(self, dim: int = 384, threshold: float = 0.92,
                 max_entries: int = 512, cluster_guard: bool = True,
                 ttl_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None):
        if not (0.0 < threshold <= 1.0):
            raise ValueError(f"threshold must be in (0, 1], got {threshold}")
        if ttl_s is not None and ttl_s <= 0.0:
            raise ValueError(f"ttl_s must be positive, got {ttl_s}")
        self.threshold = threshold
        self.max_entries = max_entries
        self.cluster_guard = cluster_guard
        self.ttl_s = ttl_s
        self._clock = clock or time.monotonic
        self._emb = np.zeros((max_entries, dim), np.float32)
        self._task = np.full(max_entries, -1, np.int64)      # -1 = free slot
        self._cluster = np.zeros(max_entries, np.int64)
        self._entries: List[Optional[SemanticEntry]] = [None] * max_entries
        self._last_used = np.zeros(max_entries, np.int64)
        self._born = np.zeros(max_entries, np.float64)       # insert time
        self._tick = 0
        self.lookups = 0
        self.hits = 0
        self.insertions = 0
        self.evictions = 0
        self.expirations = 0

    def __len__(self) -> int:
        return int(np.sum(self._task >= 0))

    def _expire(self) -> None:
        """Free every entry older than ``ttl_s`` (TTL aging runs lazily at
        lookup time — an expired slot must never answer, and freeing it
        here also makes it the next insertion target)."""
        if self.ttl_s is None:
            return
        stale = (self._task >= 0) \
            & (self._clock() - self._born > self.ttl_s)
        if stale.any():
            for slot in np.flatnonzero(stale):
                self._entries[int(slot)] = None
            self._task[stale] = -1
            self._last_used[stale] = 0
            self.expirations += int(stale.sum())

    def lookup(self, embedding: np.ndarray, task_label: int,
               cluster: int) -> Optional[SemanticEntry]:
        """Best guarded match above threshold, or None.  Ties break to the
        lowest slot index (deterministic).  With a TTL configured, aged-out
        entries are expired (freed) before matching."""
        self.lookups += 1
        self._expire()
        live = self._task == task_label
        if self.cluster_guard:
            live &= self._cluster == cluster
        if not live.any():
            return None
        sims = self._emb @ np.asarray(embedding, np.float32)
        sims = np.where(live, sims, -np.inf)
        best = int(np.argmax(sims))
        if sims[best] < self.threshold:
            return None
        self.hits += 1
        self._tick += 1
        self._last_used[best] = self._tick
        return self._entries[best]

    def insert(self, embedding: np.ndarray, entry: SemanticEntry) -> None:
        """Store a completion; evicts the LRU entry when full (expired
        slots are freed first, so a TTL'd-out entry never outcompetes a
        live one for residency)."""
        self._expire()
        free = np.flatnonzero(self._task < 0)
        if free.size:
            slot = int(free[0])
        else:
            slot = int(np.argmin(self._last_used))
            self.evictions += 1
        self._emb[slot] = np.asarray(embedding, np.float32)
        self._task[slot] = entry.task_label
        self._cluster[slot] = entry.cluster
        self._entries[slot] = entry
        self._tick += 1
        self._last_used[slot] = self._tick
        self._born[slot] = self._clock()
        self.insertions += 1

    def stats(self) -> dict:
        return {"entries": len(self), "max_entries": self.max_entries,
                "threshold": self.threshold, "lookups": self.lookups,
                "hits": self.hits, "insertions": self.insertions,
                "evictions": self.evictions, "ttl_s": self.ttl_s,
                "expirations": self.expirations}
