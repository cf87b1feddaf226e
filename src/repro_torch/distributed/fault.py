"""Failure detection: heartbeats and straggler statistics.

Generic primitives used by both the serving scheduler (engine heartbeats,
hedged dispatch) and the training launcher (step-time watchdog that
triggers checkpoint-restore / elastic re-mesh).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Heartbeat:
    """One liveness track.  ``clock`` is injectable (default wall-clock
    ``time.monotonic``) so virtual-clock harnesses — the scenario lab,
    the fleet controller's shard liveness — can drive staleness from
    modeled time instead of sleeping through real timeouts."""

    name: str
    clock: Callable[[], float] = time.monotonic
    last_beat: Optional[float] = None

    def __post_init__(self) -> None:
        if self.last_beat is None:
            self.last_beat = self.clock()

    def beat(self) -> None:
        self.last_beat = self.clock()

    def stale(self, timeout_s: float) -> bool:
        return (self.clock() - self.last_beat) > timeout_s


class HeartbeatMonitor:
    """Tracks many heartbeats; reports the stale set.  All registered
    beats share the monitor's (injectable) clock."""

    def __init__(self, timeout_s: float,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self.clock = clock
        self._beats: Dict[str, Heartbeat] = {}

    def register(self, name: str) -> Heartbeat:
        hb = Heartbeat(name, clock=self.clock)
        self._beats[name] = hb
        return hb

    def deregister(self, name: str) -> None:
        """Stop tracking ``name`` (e.g. a shard already failed over) —
        a dead entry would otherwise report stale forever."""
        self._beats.pop(name, None)

    def beat(self, name: str) -> None:
        self._beats[name].beat()

    def stale(self) -> List[str]:
        return [n for n, hb in self._beats.items()
                if hb.stale(self.timeout_s)]


class StragglerDetector:
    """Flags workers whose step times exceed a robust threshold.

    Threshold = median + k·IQR over a sliding window — the standard
    straggler test that tolerates global slowdowns (everyone slow ⇒ nobody
    flagged) while catching a single failing host.
    """

    def __init__(self, window: int = 50, k: float = 3.0):
        self.window = window
        self.k = k
        self._times: Dict[str, List[float]] = {}

    def record(self, worker: str, step_time_s: float) -> None:
        buf = self._times.setdefault(worker, [])
        buf.append(step_time_s)
        if len(buf) > self.window:
            buf.pop(0)

    def stragglers(self) -> List[str]:
        latest = {w: buf[-1] for w, buf in self._times.items() if buf}
        if len(latest) < 3:
            return []
        vals = np.array(list(latest.values()))
        med = np.median(vals)
        iqr = np.subtract(*np.percentile(vals, [75, 25])) or med * 0.05
        thresh = med + self.k * iqr
        return [w for w, t in latest.items() if t > thresh]


@dataclasses.dataclass
class TrainWatchdog:
    """Training-loop recovery policy: restore from the newest checkpoint,
    optionally on a degraded mesh (elastic)."""

    checkpoint_dir: str
    max_restarts: int = 5
    restarts: int = 0

    def should_restart(self) -> bool:
        return self.restarts < self.max_restarts

    def on_failure(self) -> int:
        self.restarts += 1
        from repro_torch.distributed import checkpoint as ckpt
        step = ckpt.latest_step(self.checkpoint_dir)
        if step is None:
            raise RuntimeError("failure before first checkpoint — "
                               "cannot recover")
        return step
