"""Structured serving-event log: admissions, completions, hedges, restarts.

A bounded ring buffer of (kind, t_s, payload) records with per-kind
counters.  Events complement the aggregated metrics: the registry answers
"what is p95 latency", the event log answers "what happened around the
restart at t=41.2s".
"""
from __future__ import annotations

from collections import Counter as KindCounter
from collections import deque
from typing import Deque, Dict, Iterable, List, NamedTuple


ADMIT = "admit"
COMPLETE = "complete"
HEDGE = "hedge"
RESTART = "restart"
LAMBDA = "lambda"           # governor changed the router's λ
CACHE_HIT = "cache_hit"     # GreenCache answered/shortened a query
ENGINE_ADDED = "engine_added"   # pool grew at runtime (add_engine)
MIGRATE = "migrate"         # prompt KV handed prefill→decode engine
DEFER = "defer"             # admission planner parked arrivals (no budget
                            # headroom for their predicted Wh this tick)
ATTEMPT_FAIL = "attempt_fail"   # one dispatch died (crash/garbage/stall)
RETRY = "retry"             # failed request re-routed away from its arm
TIMEOUT = "timeout"         # deadline passed; request terminal TIMED_OUT
BREAKER = "breaker"         # circuit breaker state transition on an arm


class Event(NamedTuple):
    """One discrete serving occurrence: ``kind`` (ADMIT/COMPLETE/HEDGE/
    RESTART/LAMBDA/CACHE_HIT/ENGINE_ADDED), ``t_s`` the caller-clock
    timestamp in seconds, and a flat ``payload`` (energies in Wh,
    latencies in ms, counts unitless)."""

    kind: str
    t_s: float
    payload: Dict[str, object]


class EventLog:
    """Ring-buffered event stream (newest ``maxlen`` kept) with O(1)
    per-kind counts; timestamps in seconds from the telemetry clock."""

    def __init__(self, maxlen: int = 8192):
        self._events: Deque[Event] = deque(maxlen=maxlen)
        self.counts: KindCounter = KindCounter()

    def emit(self, kind: str, t_s: float, **payload: object) -> Event:
        ev = Event(kind, t_s, payload)
        self._events.append(ev)
        self.counts[kind] += 1
        return ev

    def __len__(self) -> int:
        return len(self._events)

    def __iter__(self):
        return iter(self._events)

    def of_kind(self, kind: str) -> List[Event]:
        return [e for e in self._events if e.kind == kind]

    def to_rows(self) -> Iterable[dict]:
        for e in self._events:
            yield {"kind": e.kind, "t_s": e.t_s, **e.payload}
