"""Telemetry overhead + governed-vs-ungoverned energy budget benchmark.

Three sections over the paper-scale synthetic stream and 16-model pool
(``common.drive_pool_stream``: ``SimEngine``s behind ``PoolServer``, the
router on ``device``):

  1. **Overhead** — per-``PoolServer.step`` cost with and without telemetry
     recording; the subsystem must stay under 5 % (asserted in --smoke).
     The step's own work includes the router's decisions on the device
     (featurize "auto": the card's kernels), so on the card the ratio is
     the telemetry's cost beside the production decision path.
  2. **Governance** — the same stream twice: ungoverned at λ=0.4, then
     governed with a Wh budget at 60 % of the ungoverned consumption.  The
     governor must land under the cap while giving up little accuracy.
  3. **Dump** — with ``--out``, the full JSONL metrics trace of the
     governed run.

This is the JAX package's ``benchmarks/bench_telemetry.py``: the same
arguments (plus ``device``, None: the card) and the same lines.

    PYTHONPATH=src python -m repro_torch.benchmarks.telemetry [--smoke] \
        [--per-task N] [--out f] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

from repro_torch.benchmarks.common import ServeResult, drive_pool_stream
from repro_torch.core.types import Query
from repro_torch.data.stream import make_stream
from repro_torch.telemetry import EnergyBudgetGovernor, Telemetry, dump_jsonl


def run_stream(queries: Sequence[Query], telemetry: Optional[Telemetry],
               lam: float = 0.4, seed: int = 0, batch: int = 25,
               device=None) -> ServeResult:
    return drive_pool_stream(queries, telemetry, lam=lam, seed=seed,
                             batch=batch, device=device)


class TimedTelemetry(Telemetry):
    """Telemetry whose scheduler hooks accumulate their own wall time.

    The hooks are exactly the work ``PoolServer`` adds when telemetry is
    attached, so ``hook_s / (step_s - hook_s)`` is the recording overhead
    — measured inside one run, immune to the run-to-run noise of step
    timings (the bare-vs-instrumented delta is an order of magnitude
    below that noise floor).  The hooks are host code: no device work
    runs inside them, so the host clock times them whole.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.hook_s = 0.0

    def _timed(self, fn, *a, **kw):
        t0 = time.perf_counter()
        fn(*a, **kw)
        self.hook_s += time.perf_counter() - t0

    def on_admit(self, *a, **kw):
        self._timed(super().on_admit, *a, **kw)

    def on_completion(self, *a, **kw):
        self._timed(super().on_completion, *a, **kw)

    def on_hedge(self, *a, **kw):
        self._timed(super().on_hedge, *a, **kw)

    def on_restart(self, *a, **kw):
        self._timed(super().on_restart, *a, **kw)

    def on_step(self, *a, **kw):
        self._timed(super().on_step, *a, **kw)


def measure_overhead(queries: Sequence[Query], trials: int = 3,
                     device=None) -> dict:
    """Fraction of PoolServer.step spent in telemetry recording."""
    best = None
    for t in range(trials):
        tel = TimedTelemetry()
        res = run_stream(queries, tel, seed=t, device=device)
        base = res.step_s_total - tel.hook_s
        ratio = tel.hook_s / max(base, 1e-12)
        if best is None or ratio < best[0]:
            best = (ratio, res, tel)
    ratio, res, tel = best
    return {"bare_ms": (res.step_s_total - tel.hook_s)
            / max(res.n_steps, 1) * 1e3,
            "telemetry_ms": tel.hook_s / max(res.n_steps, 1) * 1e3,
            "overhead_pct": 100.0 * ratio}


def run_governed(queries: Sequence[Query], budget_wh: float,
                 lam: float = 0.4, seed: int = 0,
                 device=None) -> ServeResult:
    governor = EnergyBudgetGovernor(budget_wh,
                                    horizon_queries=len(queries))
    return run_stream(queries, Telemetry(governor=governor),
                      lam=lam, seed=seed, device=device)


def main(per_task: int = 500, smoke: bool = False,
         out: Optional[str] = None, device=None) -> List[str]:
    queries = make_stream(per_task=per_task)
    lines: List[str] = []

    ov = measure_overhead(queries[: min(len(queries), 500)],
                          trials=2 if smoke else 3, device=device)
    lines.append("section,metric,value")
    lines.append(f"overhead,bare_step_ms,{ov['bare_ms']:.4f}")
    lines.append(f"overhead,telemetry_step_ms,{ov['telemetry_ms']:.4f}")
    lines.append(f"overhead,overhead_pct,{ov['overhead_pct']:.2f}")
    if smoke and not ov["overhead_pct"] < 5.0:
        raise AssertionError(f"telemetry overhead {ov['overhead_pct']:.2f}% "
                             f">= 5% of PoolServer.step ({ov['bare_ms']:.4f}"
                             f" ms bare, {ov['telemetry_ms']:.4f} ms of "
                             f"telemetry a step)")

    ungoverned = run_stream(queries, Telemetry(), device=device)
    budget = 0.6 * ungoverned.total_energy_wh
    governed = run_governed(queries, budget, device=device)
    gov = governed.telemetry.governor
    lines.append(f"governance,ungoverned_acc,{ungoverned.mean_accuracy:.4f}")
    lines.append(f"governance,ungoverned_wh,{ungoverned.total_energy_wh:.3f}")
    lines.append(f"governance,budget_wh,{budget:.3f}")
    lines.append(f"governance,governed_acc,{governed.mean_accuracy:.4f}")
    lines.append(f"governance,governed_wh,{governed.total_energy_wh:.3f}")
    lines.append(f"governance,under_cap,"
                 f"{governed.total_energy_wh <= budget}")
    lines.append(f"governance,lambda_final,{gov.current_lambda:.3f}")
    lines.append(f"governance,lambda_adjustments,{len(gov.lambda_history)}")
    rel_acc = governed.mean_accuracy / max(ungoverned.mean_accuracy, 1e-9)
    lines.append(f"governance,relative_accuracy,{rel_acc:.4f}")
    # (as in the JAX bench, the under-cap and relative-accuracy criteria
    # are reported here, not asserted: at smoke scale the exploration
    # transient alone can exceed a 60% cap on a lucky-cheap ungoverned run)

    if out:
        tel = governed.telemetry
        n = dump_jsonl(out, tel.registry, tel.power, tel.events,
                       meta={"per_task": per_task,
                             "budget_wh": budget,
                             "ungoverned_wh": ungoverned.total_energy_wh,
                             "governed_wh": governed.total_energy_wh,
                             "ungoverned_acc": ungoverned.mean_accuracy,
                             "governed_acc": governed.mean_accuracy})
        lines.append(f"dump,rows,{n}")
        lines.append(f"dump,path,{out}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="small stream + the < 5%% overhead assertion")
    ap.add_argument("--per-task", type=int, default=None)
    ap.add_argument("--out", default=None, help="JSONL metrics dump path")
    ap.add_argument("--device", default=None,
                    help="the router's device (default: the card)")
    args = ap.parse_args()
    per_task = args.per_task or (60 if args.smoke else 500)
    print("\n".join(main(per_task=per_task, smoke=args.smoke,
                         out=args.out, device=args.device)))
