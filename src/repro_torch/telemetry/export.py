"""Metric export: Prometheus text exposition + JSONL trace dump.

Two consumers, two formats:

  * ``to_prometheus`` renders the registry in the text exposition format
    (counters/gauges verbatim, histograms as summaries with ``quantile``
    labels) — scrapeable by any Prometheus-compatible stack;
  * ``dump_jsonl`` / ``load_jsonl`` write and re-read the full recorded
    state (metrics, power series, events) as one JSON object per line —
    the per-run artifact CI uploads so the perf trajectory is inspectable
    per-PR.

Both directions are lossless for the quantities they carry;
``tests/test_torch_telemetry.py`` asserts the round-trips, and that each
package reads the other's dumps.
"""
from __future__ import annotations

import json
import re
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.telemetry.events import EventLog
from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry)
from repro_torch.telemetry.power import PowerTrace

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
_LINE_RE = re.compile(r'^([a-zA-Z_:][\w:]*)(?:\{(.*)\})?\s+(\S+)$')


def _fmt_labels(items: Tuple[Tuple[str, str], ...],
                extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    all_items = tuple(items) + tuple(extra)
    if not all_items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in all_items)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    return repr(float(v))


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render the registry in Prometheus text exposition format."""
    lines: List[str] = []
    seen_header = set()
    for m in registry:
        if m.name not in seen_header:
            seen_header.add(m.name)
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            ptype = {"counter": "counter", "gauge": "gauge",
                     "histogram": "summary"}[m.kind]
            lines.append(f"# TYPE {m.name} {ptype}")
        if isinstance(m, (Counter, Gauge)):
            lines.append(
                f"{m.name}{_fmt_labels(m.labels)} {_fmt_value(m.value)}")
        elif isinstance(m, Histogram):
            for q, v in m.quantiles.items():
                lines.append(
                    f"{m.name}"
                    f"{_fmt_labels(m.labels, (('quantile', repr(q)),))}"
                    f" {_fmt_value(v)}")
            lines.append(
                f"{m.name}_sum{_fmt_labels(m.labels)} {_fmt_value(m.sum)}")
            lines.append(
                f"{m.name}_count{_fmt_labels(m.labels)} {m.count}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                                        float]:
    """Parse exposition text back to {(name, label items): value} — enough
    to verify a scrape round-trips the recorded series."""
    out: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        name, labels_body, value = m.groups()
        items = tuple(sorted(_LABEL_RE.findall(labels_body or "")))
        out[(name, items)] = float(value)
    return out


# ---------------------------------------------------------------------------
# JSONL traces
# ---------------------------------------------------------------------------


def to_jsonl_rows(registry: Optional[MetricsRegistry] = None,
                  power: Optional[PowerTrace] = None,
                  events: Optional[EventLog] = None,
                  meta: Optional[dict] = None) -> Iterable[dict]:
    if meta:
        yield {"type": "meta", **meta}
    if registry is not None:
        for m in registry:
            row = {"type": m.kind, "name": m.name, "labels": dict(m.labels)}
            if isinstance(m, (Counter, Gauge)):
                row["value"] = m.value
            elif isinstance(m, Histogram):
                row.update(count=m.count, sum=m.sum,
                           min=(None if m.count == 0 else m.min),
                           max=(None if m.count == 0 else m.max),
                           quantiles={repr(q): v
                                      for q, v in m.quantiles.items()})
            yield row
    if power is not None:
        for row in power.to_rows():
            yield {"type": "power", **row}
    if events is not None:
        for row in events.to_rows():
            yield {"type": "event", **row}


def dump_jsonl(path: str, registry: Optional[MetricsRegistry] = None,
               power: Optional[PowerTrace] = None,
               events: Optional[EventLog] = None,
               meta: Optional[dict] = None) -> int:
    n = 0
    with open(path, "w") as f:
        for row in to_jsonl_rows(registry, power, events, meta):
            f.write(json.dumps(row, sort_keys=True) + "\n")
            n += 1
    return n


def load_jsonl(path: str) -> Dict[str, List[dict]]:
    """Re-read a trace dump, grouped by row type."""
    out: Dict[str, List[dict]] = {"meta": [], "counter": [], "gauge": [],
                                  "histogram": [], "power": [], "event": []}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            row = json.loads(line)
            out.setdefault(row.get("type", "unknown"), []).append(row)
    return out
