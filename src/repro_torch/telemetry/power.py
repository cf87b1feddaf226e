"""Power traces: per-step energy deltas → watts time-series.

``EnergyMonitor`` (core.energy) accumulates joules; this module turns those
cumulative counters into the time-resolved signal the paper's GPU setup
gets from zeus/NVML for free: instantaneous watts per engine and pool-wide,
with running average/peak and total Wh derivable from the same samples.

The trace is sampled once per scheduler step with a caller-supplied clock
(wall time in live serving, virtual time in simulation) so power numbers
stay meaningful in both regimes.  Units throughout: timestamps in seconds,
rates in watts, cumulative counters in joules (divide by 3600 for Wh).

Besides per-engine series and the pool aggregate, two reserved phase
series (``PHASE_PREFILL`` / ``PHASE_DECODE``) split the pool's burn by
serving phase when engines report phase-tagged joules, and a reserved
``AVOIDED`` series tracks the GreenCache counterfactual — joules the pool
*would* have burned without prefix/semantic reuse ("avoided watts" reads
like any other source).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, Iterable, List, NamedTuple, Optional, Tuple

from repro_torch.core.energy import JOULES_PER_WH

POOL = "__pool__"           # reserved source name for the pool-wide series
PHASE_PREFILL = "__prefill__"   # pool-wide prefill-phase joules series
PHASE_DECODE = "__decode__"     # pool-wide decode-phase joules series
AVOIDED = "__avoided__"         # pool-wide GreenCache avoided-joules series
_RESERVED = (POOL, PHASE_PREFILL, PHASE_DECODE, AVOIDED)
PHASE_SOURCES = {"prefill": PHASE_PREFILL, "decode": PHASE_DECODE}


class PowerSample(NamedTuple):
    t_s: float                  # sample timestamp (clock supplied by caller)
    watts: float                # mean power over (prev sample, this sample]
    joules_cum: float           # cumulative joules at sample time


class PowerTrace:
    """Ring-buffered watts series per source plus pool-wide aggregate.

    ``sample(name, t_s, joules_cum)`` differentiates the cumulative joule
    counter against the previous sample.  Zero-dt samples fold into the
    next interval instead of dividing by zero.
    """

    def __init__(self, maxlen: int = 4096):
        self.maxlen = maxlen
        self._series: Dict[str, Deque[PowerSample]] = {}
        self._last: Dict[str, Tuple[float, float]] = {}   # name -> (t, J)
        self._peak: Dict[str, float] = {}
        self._joules: Dict[str, float] = {}
        self._t0: Dict[str, float] = {}
        self._t_last: Dict[str, float] = {}

    def sample(self, name: str, t_s: float, joules_cum: float) -> None:
        last = self._last.get(name)
        if last is None:
            # first observation anchors the series, no rate yet
            self._last[name] = (t_s, joules_cum)
            self._t0[name] = t_s
            self._t_last[name] = t_s
            self._series[name] = deque(maxlen=self.maxlen)
            self._peak[name] = 0.0
            self._joules[name] = 0.0
            return
        t_prev, j_prev = last
        dt = t_s - t_prev
        dj = joules_cum - j_prev
        if dt <= 0.0:
            # clock did not advance; accumulate into the next interval
            self._last[name] = (t_prev, j_prev)
            return
        watts = max(dj, 0.0) / dt
        self._series[name].append(PowerSample(t_s, watts, joules_cum))
        self._last[name] = (t_s, joules_cum)
        self._t_last[name] = t_s
        self._joules[name] += max(dj, 0.0)
        if watts > self._peak[name]:
            self._peak[name] = watts

    def sample_all(self, t_s: float, joules_by_source: Dict[str, float],
                   phase_joules: Optional[Dict[str, float]] = None) -> None:
        """One scheduler-step sample: every engine plus the pool total.

        ``phase_joules`` optionally carries pool-wide cumulative joules per
        serving phase ({"prefill": J, "decode": J}); each phase becomes its
        own reserved series (``PHASE_PREFILL`` / ``PHASE_DECODE``) so watts
        can be read per phase — prefill is compute-bound and decode
        bandwidth-bound, and lumping them hides which roofline is burning
        the budget."""
        for name, j in joules_by_source.items():
            self.sample(name, t_s, j)
        self.sample(POOL, t_s, sum(joules_by_source.values()))
        for phase, j in (phase_joules or {}).items():
            src = PHASE_SOURCES.get(phase)
            if src is not None:
                self.sample(src, t_s, j)

    # -- readers ------------------------------------------------------------

    @property
    def sources(self) -> List[str]:
        """Engine source names (reserved pool/phase aggregates excluded)."""
        return [n for n in self._series if n not in _RESERVED]

    def series(self, name: str = POOL) -> List[PowerSample]:
        return list(self._series.get(name, ()))

    def last_watts(self, name: str = POOL) -> float:
        s = self._series.get(name)
        return s[-1].watts if s else 0.0

    def peak_watts(self, name: str = POOL) -> float:
        return self._peak.get(name, 0.0)

    def avg_watts(self, name: str = POOL) -> float:
        dur = self._t_last.get(name, 0.0) - self._t0.get(name, 0.0)
        if dur <= 0.0:
            return 0.0
        return self._joules.get(name, 0.0) / dur

    def total_wh(self, name: str = POOL) -> float:
        return self._joules.get(name, 0.0) / JOULES_PER_WH

    def to_rows(self) -> Iterable[dict]:
        """Flat dict rows (for JSONL export)."""
        for name in sorted(self._series):
            for s in self._series[name]:
                yield {"source": name, "t_s": s.t_s, "watts": s.watts,
                       "joules_cum": s.joules_cum}
