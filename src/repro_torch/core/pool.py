"""Heterogeneous model pool registry with runtime addition (paper §4.4)."""
from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.types import ModelProfile, Query


class ModelPool:
    """Ordered registry of pool members; index == bandit arm index.

    Thread-safe: the serving scheduler adds models from a control thread
    while the router reads the pool on the request path.
    """

    def __init__(self, profiles: Optional[List[ModelProfile]] = None):
        self._lock = threading.RLock()
        self._profiles: List[ModelProfile] = []
        self._by_name: Dict[str, int] = {}
        self._listeners: List[Callable[[ModelProfile, int], None]] = []
        for p in profiles or []:
            self.add(p)

    def __len__(self) -> int:
        with self._lock:
            return len(self._profiles)

    def __getitem__(self, idx: int) -> ModelProfile:
        with self._lock:
            return self._profiles[idx]

    def index_of(self, name: str) -> int:
        with self._lock:
            return self._by_name[name]

    @property
    def names(self) -> List[str]:
        with self._lock:
            return [p.name for p in self._profiles]

    def on_add(self, fn: Callable[[ModelProfile, int], None]) -> None:
        """Register a callback fired when a model joins (router adds an arm)."""
        self._listeners.append(fn)

    def add(self, profile: ModelProfile) -> int:
        with self._lock:
            if profile.name in self._by_name:
                raise ValueError(f"duplicate model {profile.name!r}")
            idx = len(self._profiles)
            self._profiles.append(profile)
            self._by_name[profile.name] = idx
        for fn in self._listeners:
            fn(profile, idx)
        return idx

    def feasible_mask(self, query: Query) -> np.ndarray:
        """Eq. 4: M_t* = {m : L_m(q_t) <= L_max}. Conservative latency estimate
        uses MaxNewTokens for the query's task (paper §4.3 State Extractor)."""
        with self._lock:
            mask = np.array(
                [p.latency_estimate_ms(query.max_new_tokens) <= query.latency_budget_ms
                 for p in self._profiles], dtype=bool)
        if mask.size and not mask.any():
            # If nothing is feasible the paper discards the query; serving
            # systems must answer — degrade to the fastest model instead.
            with self._lock:
                fastest = int(np.argmin(
                    [p.latency_estimate_ms(query.max_new_tokens) for p in self._profiles]))
            mask[fastest] = True
        return mask
