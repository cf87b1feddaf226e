"""Lightweight metrics primitives: counters, gauges, streaming histograms.

Designed for the serving hot path — every ``record`` is O(1):

  * ``Counter`` / ``Gauge``   — a float plus bookkeeping, nothing else;
  * ``Histogram``             — count/sum/min/max plus P² streaming quantile
    estimators (Jain & Chlamtáč 1985) for p50/p95/p99, so latency
    percentiles never require storing or sorting samples; the estimators
    take the observations in batches (at most ``PENDING_MAX`` held), each
    one folded in by the time anything reads a quantile;
  * ``MetricsRegistry``       — get-or-create by (name, labels); iteration
    order is stable for deterministic export; ``flush`` folds every
    histogram's pending observations (the telemetry hub's, once a
    scheduler step).

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
PENDING_MAX = 1024      # observations a histogram holds before it folds them


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


def _p2_move(h_lo: float, h_i: float, h_hi: float, p_lo: float, p_i: float,
             p_hi: float, d: float) -> float:
    """An interior marker's new height for a move of ``d`` = ±1: the
    piecewise-parabolic (P²) prediction, or the linear one toward the
    neighbour in the direction of the move when the parabola leaves the
    neighbours' bracket."""
    cand = h_i + d / (p_hi - p_lo) * (
        (p_i - p_lo + d) * (h_hi - h_i) / (p_hi - p_i)
        + (p_hi - p_i - d) * (h_i - h_lo) / (p_i - p_lo))
    if h_lo < cand < h_hi:
        return cand
    if d > 0:
        return h_i + d * (h_hi - h_i) / (p_hi - p_i)
    return h_i + d * (h_lo - h_i) / (p_lo - p_i)


class P2Quantile:
    """P² single-quantile estimator: O(1) update, O(1) memory (5 markers).

    Tracks the running ``q``-quantile of a stream without storing it.  The
    first five observations seed the markers exactly; afterwards marker
    heights move by the piecewise-parabolic (P²) formula.  Accuracy is a
    few percent on smooth distributions — plenty for serving dashboards.
    """

    __slots__ = ("q", "n", "heights", "positions", "_coef")

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self.n = 0
        self.heights: List[float] = []
        self.positions = [1.0, 2.0, 3.0, 4.0, 5.0]
        # desired positions of the interior markers are affine in the
        # post-seed count, so they are computed on demand instead of stored
        # and incremented: their intercepts, then their slopes
        self._coef = (1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q,
                      q / 2.0, q, (1.0 + q) / 2.0)

    def update(self, x: float) -> None:
        self.update_many((x,))

    def update_many(self, xs: Iterable[float]) -> None:
        """``update`` with each of ``xs`` in order.  The JAX package's
        update, with the markers held in local variables and the interior
        loop unrolled: the same comparisons and the same float operations
        in the same order, so the markers are bit-equal to it
        (tests/test_torch_telemetry.py), at about half its cost an
        observation over a batch — ``Histogram`` folds its observations
        in batches, once a scheduler step (``Telemetry.on_step``)."""
        h = self.heights
        xs = iter(xs)
        while self.n < 5:
            x = next(xs, None)
            if x is None:
                return
            self.n += 1
            h.append(float(x))
            h.sort()
        p = self.positions
        h0, h1, h2, h3, h4 = h
        p0, p1, p2, p3, p4 = p
        a1, a2, a3, b1, b2, b3 = self._coef
        n = self.n
        for x in xs:
            x = float(x)
            n += 1
            # the cell x falls in: every marker above it moves up a place
            if x < h1:
                if x < h0:
                    h0 = x
                p1 += 1.0
                p2 += 1.0
                p3 += 1.0
            elif x < h2:
                p2 += 1.0
                p3 += 1.0
            elif x < h3:
                p3 += 1.0
            elif x >= h4:
                h4 = x
            p4 += 1.0
            # adjust interior markers toward their desired positions
            m = float(n - 5)
            d = a1 + b1 * m - p1
            if (d >= 1.0 and p2 - p1 > 1.0) or (d <= -1.0 and p0 - p1 < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                h1 = _p2_move(h0, h1, h2, p0, p1, p2, d)
                p1 += d
            d = a2 + b2 * m - p2
            if (d >= 1.0 and p3 - p2 > 1.0) or (d <= -1.0 and p1 - p2 < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                h2 = _p2_move(h1, h2, h3, p1, p2, p3, d)
                p2 += d
            d = a3 + b3 * m - p3
            if (d >= 1.0 and p4 - p3 > 1.0) or (d <= -1.0 and p2 - p3 < -1.0):
                d = 1.0 if d >= 1.0 else -1.0
                h3 = _p2_move(h2, h3, h4, p2, p3, p4, d)
                p3 += d
        self.n = n
        h[:] = (h0, h1, h2, h3, h4)
        p[:] = (p0, p1, p2, p3, p4)

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
        self._pending: List[float] = []

    def record(self, v: float) -> None:
        """count/sum/min/max at once; the quantile estimators take ``v`` at
        the next ``flush`` (a reader's, or the registry's once a scheduler
        step), in the order recorded."""
        v = float(v)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        pending = self._pending
        pending.append(v)
        if len(pending) >= PENDING_MAX:
            self.flush()

    def flush(self) -> None:
        """Fold the observations recorded since the last flush into the
        quantile estimators."""
        if self._pending:
            xs, self._pending = self._pending, []
            for est in self._estimators.values():
                est.update_many(xs)

    def quantile(self, q: float) -> float:
        self.flush()
        return self._estimators[q].value

    @property
    def quantiles(self) -> Dict[float, float]:
        self.flush()
        return {q: est.value for q, est in self._estimators.items()}

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricsRegistry:
    """Get-or-create metric store keyed on (name, sorted label items)."""

    def __init__(self):
        self._metrics: Dict[Tuple[str, LabelItems], object] = {}
        self._histograms: List[Histogram] = []

    def _get(self, cls, name: str, labels: Optional[Dict[str, str]],
             help: str, **kwargs):
        key = (name, _label_items(labels or {}))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name=name, labels=key[1], help=help, **kwargs)
            self._metrics[key] = m
            if cls is Histogram:
                self._histograms.append(m)
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

    def flush(self) -> None:
        """Fold every histogram's pending observations into its quantile
        estimators."""
        for h in self._histograms:
            h.flush()

    def __iter__(self) -> Iterable:
        # stable order: by name then labels, for deterministic export
        for key in sorted(self._metrics):
            yield self._metrics[key]

    def __len__(self) -> int:
        return len(self._metrics)

    def find(self, name: str, labels: Optional[Dict[str, str]] = None):
        return self._metrics.get((name, _label_items(labels or {})))
