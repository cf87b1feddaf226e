"""Telemetry & adaptive energy-budget governance for the serving stack.

Turns "routing that measures energy" into "serving that governs energy":

  * ``metrics``  — O(1) counters/gauges/streaming-quantile histograms;
  * ``power``    — per-engine and pool-wide watts time-series;
  * ``budget``   — ``EnergyBudgetGovernor``: a Wh token bucket that
    modulates the router's λ online (``GreenServRouter.set_lambda``);
  * ``events``   — bounded structured event log;
  * ``export``   — Prometheus text exposition + JSONL trace round-trip;
  * ``hub``      — the ``Telemetry`` facade ``PoolServer`` reports into.

This package is the JAX package's ``repro/telemetry`` (pure Python and
numpy), carried as its own copy.  Its watts are *modeled*: the power trace
differentiates the engines' joule ledgers, which ``core/energy.py`` charges
from the H100's published constants — they are not read from the card's
power sensor (NVML).
"""
from repro_torch.telemetry.budget import (EnergyBudgetGovernor,
                                          diurnal_carbon_intensity)
from repro_torch.telemetry.events import Event, EventLog
from repro_torch.telemetry.export import (dump_jsonl, load_jsonl,
                                          parse_prometheus, to_prometheus)
from repro_torch.telemetry.hub import Telemetry
from repro_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                           MetricsRegistry, P2Quantile)
from repro_torch.telemetry.power import PowerSample, PowerTrace

__all__ = [
    "EnergyBudgetGovernor", "diurnal_carbon_intensity",
    "Event", "EventLog",
    "dump_jsonl", "load_jsonl", "parse_prometheus", "to_prometheus",
    "Telemetry",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "P2Quantile",
    "PowerSample", "PowerTrace",
]
