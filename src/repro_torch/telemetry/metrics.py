"""Lightweight metrics primitives: counters, gauges, streaming histograms.

Designed for the serving hot path — every ``record`` is O(1):

  * ``Counter`` / ``Gauge``   — a float plus bookkeeping, nothing else;
  * ``Histogram``             — count/sum/min/max plus P² streaming quantile
    estimators (Jain & Chlamtáč 1985) for p50/p95/p99, so latency
    percentiles never require storing or sorting samples;
  * ``MetricsRegistry``       — get-or-create by (name, labels); iteration
    order is stable for deterministic export.

Energy-per-token is a first-class serving metric (Wilhelm et al.,
arXiv:2603.20224): the registry conventions below (``greenserv_*`` names,
``model`` label) are what ``telemetry.export`` turns into Prometheus text
exposition and JSONL traces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

LabelItems = Tuple[Tuple[str, str], ...]

DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


def _label_items(labels: Dict[str, str]) -> LabelItems:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


@dataclasses.dataclass
class Counter:
    """Monotonically increasing count (events, tokens, Wh·1e3, ...)."""

    name: str
    labels: LabelItems = ()
    help: str = ""
    value: float = 0.0

    kind = "counter"

    def inc(self, v: float = 1.0) -> None:
        self.value += v


@dataclasses.dataclass
class Gauge:
    """Point-in-time value (queue depth, current λ, watts)."""

    name: str
    labels: LabelItems = ()
    help: str = ""
    value: float = 0.0
    n_sets: int = 0

    kind = "gauge"

    def set(self, v: float) -> None:
        self.value = float(v)
        self.n_sets += 1


class P2Quantile:
    """P² single-quantile estimator: O(1) update, O(1) memory (5 markers).

    Tracks the running ``q``-quantile of a stream without storing it.  The
    first five observations seed the markers exactly; afterwards marker
    heights move by the piecewise-parabolic (P²) formula.  Accuracy is a
    few percent on smooth distributions — plenty for serving dashboards.
    """

    __slots__ = ("q", "n", "heights", "positions", "_d0", "_inc")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self.n = 0
        self.heights: List[float] = []
        self.positions = [1.0, 2.0, 3.0, 4.0, 5.0]
        # desired marker positions are affine in the post-seed count, so
        # they are computed on demand instead of stored and incremented —
        # update() runs per request on the serving hot path
        self._d0 = (1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0)
        self._inc = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)

    def update(self, x: float) -> None:
        x = float(x)
        h = self.heights
        self.n += 1
        if self.n <= 5:
            h.append(x)
            h.sort()
            return
        pos = self.positions
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        elif x < h[1]:
            k = 0
        elif x < h[2]:
            k = 1
        elif x < h[3]:
            k = 2
        else:
            k = 3
        for i in range(k + 1, 5):
            pos[i] += 1.0
        # adjust interior markers toward their desired positions
        m = float(self.n - 5)
        d0, inc = self._d0, self._inc
        for i in (1, 2, 3):
            d = d0[i] + inc[i] * m - pos[i]
            if ((d >= 1.0 and pos[i + 1] - pos[i] > 1.0)
                    or (d <= -1.0 and pos[i - 1] - pos[i] < -1.0)):
                d = 1.0 if d >= 1.0 else -1.0
                cand = self._parabolic(i, d)
                if not h[i - 1] < cand < h[i + 1]:
                    cand = self._linear(i, d)
                h[i] = cand
                pos[i] += d

    def _parabolic(self, i: int, d: float) -> float:
        h, p = self.heights, self.positions
        return h[i] + d / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + d) * (h[i + 1] - h[i]) / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - d) * (h[i] - h[i - 1]) / (p[i] - p[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, p = self.heights, self.positions
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (p[j] - p[i])

    @property
    def value(self) -> float:
        if not self.heights:
            return 0.0
        if self.n < 5:
            # exact small-sample quantile over the seeded markers
            idx = min(int(self.q * len(self.heights)), len(self.heights) - 1)
            return self.heights[idx]
        return self.heights[2]


class Histogram:
    """Streaming distribution summary: count/sum/min/max + P² quantiles."""

    kind = "histogram"

    def __init__(self, name: str, labels: LabelItems = (), help: str = "",
                 quantiles: Tuple[float, ...] = DEFAULT_QUANTILES):
        self.name = name
        self.labels = labels
        self.help = help
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._estimators = {q: P2Quantile(q) for q in quantiles}
        self._est_seq = tuple(self._estimators.values())

    def record(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        for est in self._est_seq:
            est.update(v)

    def quantile(self, q: float) -> float:
        return self._estimators[q].value

    @property
    def quantiles(self) -> Dict[float, float]:
        return {q: est.value for q, est in self._estimators.items()}

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create metric store keyed on (name, sorted label items)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelItems], object] = {}

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]],
             help: str, **kwargs):
        key = (name, _label_items(labels or {}))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name=name, labels=key[1], help=help, **kwargs)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None,
                help: str = "") -> Counter:
        return self._get(Counter, name, labels, help)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None,
              help: str = "") -> Gauge:
        return self._get(Gauge, name, labels, help)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  help: str = "",
                  quantiles: Tuple[float, ...] = DEFAULT_QUANTILES
                  ) -> Histogram:
        return self._get(Histogram, name, labels, help, quantiles=quantiles)

    def __iter__(self) -> Iterable:
        # stable order: by name then labels, for deterministic export
        for key in sorted(self._metrics):
            yield self._metrics[key]

    def __len__(self) -> int:
        return len(self._metrics)

    def find(self, name: str, labels: Optional[Dict[str, str]] = None):
        return self._metrics.get((name, _label_items(labels or {})))
