"""Deterministic chaos fault injection for serving engines.

``FaultInjector`` wraps any engine (``SimEngine``, ``ModelEngine``)
behind the same ``BaseEngine`` surface and
injects faults on a fixed schedule of :class:`FaultSpec` entries, all
timed against the injected ``clock`` — the same virtual clock the bench
loop advances, so a chaos run is reproducible tick-for-tick from its
seed.  It is the JAX package's ``repro/serving/faults.py``; the
taxonomy (docs/RELIABILITY.md):

  ``crash``           one-shot: sets the inner engine's failure flag at
                      ``t_s`` — the next step raises ``EngineFailure``
                      and the scheduler's restart path takes over
  ``stall``           window: ``step()`` does nothing for ``duration_s``
                      (heartbeat freezes; modeled time still accrues a
                      small per-tick cost so virtual-clock loops keep
                      advancing instead of livelocking on a 0-dt tick)
  ``slow``            window: only every ``magnitude``-th tick reaches
                      the inner engine (a thermally-throttled / noisy
                      neighbour step-time multiplier)
  ``garbage``         window: completions come back corrupted — the
                      NaN/inf-logits failure mode.  Energy was really
                      burned; tokens/text are gone, accuracy is zero,
                      and ``resp.corrupt`` marks them for the scheduler
  ``drop_migration``  window: phase-boundary KV payloads vanish in
                      transit; the request re-prefills on this engine
                      (the same fallback as a vanished decode twin)

Deliberately NOT a ``BaseEngine`` subclass: the base class defines
``pending`` (and friends) as raising properties, which would shadow the
``__getattr__`` delegation below.  Everything not explicitly intercepted
— queues, caches, joule ledgers, heartbeats, the ``_failed`` flag —
resolves on the wrapped engine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.serving.request import Request, RequestState, Response

FAULT_KINDS = ("crash", "stall", "slow", "garbage", "drop_migration")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault.  ``t_s`` is on the engine's clock (virtual
    seconds in the benches).  ``duration_s`` bounds window faults and is
    ignored by ``crash``; ``magnitude`` is the ``slow`` step multiplier
    (every m-th tick runs)."""

    t_s: float
    kind: str
    duration_s: float = 0.0
    magnitude: float = 2.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")

    def active(self, t: float) -> bool:
        return self.t_s <= t < self.t_s + self.duration_s


class FaultInjector:
    """Engine wrapper executing a :class:`FaultSpec` schedule (module
    docstring has the taxonomy).  ``stats`` counts what actually fired —
    the chaos bench asserts against it."""

    # modeled seconds a stalled/skipped tick still costs.  A stall that
    # accrued *zero* modeled time would freeze a virtual-clock loop (it
    # advances by the max per-tick modeled-time delta); a real stalled
    # accelerator still burns wall time, so the window elapses.
    STALL_TICK_S = 0.02

    def __init__(self, inner, faults: List[FaultSpec],
                 clock: Optional[Callable[[], float]] = None):
        self._inner = inner
        self.faults = sorted(faults, key=lambda f: f.t_s)
        self.clock = clock or getattr(inner, "clock", None) or time.monotonic
        self._crashed = set()      # indices of crash specs already fired
        self._tick = 0
        self._stall_time_s = 0.0
        self.stats: Dict[str, int] = {
            "crashes": 0, "stall_steps": 0, "slow_skips": 0,
            "garbage": 0, "dropped_migrations": 0}

    # -- schedule queries ------------------------------------------------------

    def _active_spec(self, t: float, kind: str) -> Optional[FaultSpec]:
        for spec in self.faults:
            if spec.kind == kind and spec.active(t):
                return spec
        return None

    def _fire_crashes(self, t: float) -> None:
        for i, spec in enumerate(self.faults):
            if spec.kind == "crash" and i not in self._crashed \
                    and t >= spec.t_s:
                self._crashed.add(i)
                self.stats["crashes"] += 1
                self._inner.inject_failure()

    # -- intercepted engine surface -------------------------------------------

    def step(self) -> List[Response]:
        t = self.clock()
        self._fire_crashes(t)      # inner.step() raises EngineFailure
        if self._active_spec(t, "stall") is not None:
            self.stats["stall_steps"] += 1
            self._stall_time_s += self.STALL_TICK_S
            return []
        slow = self._active_spec(t, "slow")
        if slow is not None:
            self._tick += 1
            if self._tick % max(int(slow.magnitude), 1):
                self.stats["slow_skips"] += 1
                self._stall_time_s += self.STALL_TICK_S
                return []
        out = self._inner.step()
        if out and self._active_spec(t, "garbage") is not None:
            for resp in out:
                # NaN/inf logits: the compute (and its energy) happened,
                # the output is unusable.  The scheduler decides whether
                # to retry (reliability on) or complete at zero accuracy.
                resp.tokens = []
                resp.text = ""
                resp.accuracy = 0.0          # type: ignore[attr-defined]
                resp.corrupt = True          # type: ignore[attr-defined]
                self.stats["garbage"] += 1
        return out

    def drain_migrations(self) -> List[Request]:
        out = self._inner.drain_migrations()
        if not out or self._active_spec(
                self.clock(), "drop_migration") is None:
            return out
        for req in out:
            # payload lost in transit — re-prefill locally, exactly the
            # scheduler's vanished-twin fallback (nothing is ever lost)
            req.kv_payload = None
            req.kv_migrated = 0
            req.prefill_wh = 0.0
            req.state = RequestState.QUEUED
            req.generated = []
            req.n_prompt_fed = 0
            req.prefix_reused = 0
            self._inner.submit(req)
            self.stats["dropped_migrations"] += 1
        return []

    def modeled_time_s(self) -> float:
        return self._inner.modeled_time_s() + self._stall_time_s

    def restart(self) -> List[Request]:
        # the schedule survives a restart: chaos doesn't stop because
        # the pool recovered (crashes already fired stay fired)
        return self._inner.restart()

    def __getattr__(self, name: str):
        return getattr(self._inner, name)


def fault_storm(span_s: float, target: str, others: List[str],
                seed: int = 0, frac_start: float = 0.35,
                frac_end: float = 0.65, n_crashes: int = 2,
                background_rate: float = 0.5) -> Dict[str, List[FaultSpec]]:
    """Seeded per-engine fault schedules for a chaos scenario: a
    concentrated crash + garbage storm on ``target`` inside the
    [frac_start, frac_end] window of the run's modeled span, plus sparse
    background stalls/slowdowns on ``others`` (~``background_rate``
    faults per engine).  Deterministic in (seed, span, names).

    Crashes are the bandit-proof damage: a garbage completion feeds the
    router a zero-accuracy observation it can learn from, but a crash on
    the legacy (reliability-off) path just replays the wiped work on the
    same engine once it restarts — the joules are burned twice and the
    router never hears about it.  ``n_crashes`` spreads that many crashes
    evenly through the window (jittered within their slots)."""
    rng = np.random.default_rng(seed)
    t0, t1 = span_s * frac_start, span_s * frac_end
    storm: List[FaultSpec] = [
        # garbage first: the arm degrades, the bandit and breaker see
        # zero-accuracy observations, then it crashes outright mid-window
        FaultSpec(t_s=t0, kind="garbage", duration_s=(t1 - t0)),
    ]
    slot = (t1 - t0) / max(n_crashes, 1)
    for i in range(max(n_crashes, 0)):
        lo = t0 + i * slot
        storm.append(FaultSpec(
            t_s=float(rng.uniform(lo, lo + slot)), kind="crash"))
    schedules: Dict[str, List[FaultSpec]] = {target: storm}
    for name in others:
        faults: List[FaultSpec] = []
        n = rng.poisson(background_rate)
        for _ in range(int(n)):
            kind = str(rng.choice(["stall", "slow"]))
            faults.append(FaultSpec(
                t_s=float(rng.uniform(0.0, span_s * 0.9)), kind=kind,
                duration_s=float(rng.uniform(0.02, span_s * 0.05)),
                magnitude=float(rng.integers(2, 5))))
        if faults:
            schedules[name] = faults
    return schedules


__all__ = ["FAULT_KINDS", "FaultSpec", "FaultInjector", "fault_storm"]
