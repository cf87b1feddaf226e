"""Per-arm circuit breakers for failure-aware routing (docs/RELIABILITY.md).

A :class:`CircuitBreaker` guards one (engine, role) arm of the pool with
the classic three-state machine over a rolling failure-rate window:

  CLOSED ──(failure rate ≥ threshold over ≥ min_samples)──▶ OPEN
  OPEN ──(``open_steps`` scheduler steps elapse)──▶ HALF_OPEN
  HALF_OPEN ──(``probe_successes`` probes succeed)──▶ CLOSED
  HALF_OPEN ──(any probe fails)──▶ OPEN (cooldown restarts)

Time is measured in *scheduler steps*, not wall seconds — the serving
benches run on a virtual clock, and a breaker keyed to wall time would
either never cool down (idle-jumps skip hours in one tick) or flap.  The
scheduler passes its step counter into every call.

``routable`` is the routing-mask predicate ``PoolServer`` aggregates into
the router's arm-health mask: OPEN arms are masked out of
``route_batch``'s argmax entirely; HALF_OPEN arms take a *probe trickle*
— at most ``probe_quota`` in-flight requests at a time — so one success
or failure decides the arm's fate before real traffic returns to it.
The mask can never make routing impossible: ``GreenServRouter`` falls
back to the unmasked feasibility row when every arm of a query is
breaker-blocked (serving must answer; see ``_feasible_matrix``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Deque, Optional

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Knobs for one arm's breaker (shared by the whole pool — the
    scheduler instantiates one breaker per (engine, role) from this).

    ``window``            rolling attempt window (successes + failures)
    ``failure_threshold`` open when failures/window ≥ this …
    ``min_samples``       … and the window holds at least this many attempts
    ``open_steps``        OPEN cooldown, in scheduler steps
    ``probe_quota``       concurrent probes allowed while HALF_OPEN
    ``probe_successes``   consecutive probe successes required to close
    """

    window: int = 16
    failure_threshold: float = 0.5
    min_samples: int = 4
    open_steps: int = 60
    probe_quota: int = 1
    probe_successes: int = 2

    def __post_init__(self):
        if not (0.0 < self.failure_threshold <= 1.0):
            raise ValueError(
                f"failure_threshold must be in (0, 1], got "
                f"{self.failure_threshold}")
        if self.window < 1 or self.min_samples < 1:
            raise ValueError("window and min_samples must be >= 1")


class CircuitBreaker:
    """One arm's failure-rate state machine (module docstring has the
    transition diagram).  ``on_transition(old, new, step)`` fires on every
    state change — the scheduler wires it to telemetry."""

    def __init__(self, config: Optional[BreakerConfig] = None,
                 on_transition: Optional[
                     Callable[[str, str, int], None]] = None):
        self.config = config or BreakerConfig()
        self.state = CLOSED
        self.on_transition = on_transition
        # rolling attempt window: True = failure
        self._window: Deque[bool] = deque(maxlen=self.config.window)
        self._opened_at = 0
        self._probe_ok = 0
        self.n_opens = 0

    def _transition(self, new: str, step: int) -> None:
        old, self.state = self.state, new
        if new == OPEN:
            self.n_opens += 1
            self._opened_at = step
        if new == HALF_OPEN:
            self._probe_ok = 0
        if new == CLOSED:
            self._window.clear()
        if self.on_transition is not None and old != new:
            self.on_transition(old, new, step)

    def failure_rate(self) -> float:
        if not self._window:
            return 0.0
        return sum(self._window) / len(self._window)

    def record_success(self, step: int) -> None:
        if self.state == HALF_OPEN:
            self._probe_ok += 1
            if self._probe_ok >= self.config.probe_successes:
                self._transition(CLOSED, step)
            return
        self._window.append(False)

    def record_failure(self, step: int) -> None:
        if self.state == HALF_OPEN:
            # the probe died: straight back to OPEN, cooldown restarts
            self._transition(OPEN, step)
            return
        if self.state == OPEN:
            return
        self._window.append(True)
        if (len(self._window) >= self.config.min_samples
                and self.failure_rate() >= self.config.failure_threshold):
            self._transition(OPEN, step)

    def routable(self, step: int, pending: int = 0) -> bool:
        """May the router send (more) work to this arm right now?
        ``pending`` is the arm's current queue+slot occupancy — HALF_OPEN
        admits probes only while it sits under ``probe_quota``.  Calling
        this advances the OPEN→HALF_OPEN cooldown transition (the breaker
        has no timer of its own)."""
        if self.state == OPEN:
            if step - self._opened_at >= self.config.open_steps:
                self._transition(HALF_OPEN, step)
            else:
                return False
        if self.state == HALF_OPEN:
            return pending < self.config.probe_quota
        return True


__all__ = ["BreakerConfig", "CircuitBreaker", "CLOSED", "OPEN", "HALF_OPEN"]
