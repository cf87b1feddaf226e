"""Benchmark aggregator: one section per paper table/figure, CSV output —
the port's twin of the JAX package's ``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast|--full] \
        [--device cpu]

The sections, their titles, order and sizes (default, ``--fast``,
``--full``) are the reference's; every section runs on ``--device``
(default: the card).  Two differences:

  * the reference's last section, ``Roofline table (from dry-run
    records)``, is left out: it reads the records of the dry-run cost
    walk (``launch/dryrun.py``), which the port does not have yet;
  * a section that raises still prints the reference's ``# FAILED: ...``
    line and the run goes on to the next section, but ``main`` then
    returns 1 (the CLI's exit code), so a failed section never ends in
    exit 0.

``BENCH_*.json`` artifacts are written only where the reference's
sections write them (baselines, RouterBench, GreenCache), in the working
directory.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fast", action="store_true",
                    help="smaller streams (CI-speed)")
    ap.add_argument("--full", action="store_true",
                    help="paper-scale T=2500 / 5-run settings")
    ap.add_argument("--device", default=None,
                    help="every section's device (default: the card)")
    args = ap.parse_args(argv)
    per_task = 100 if args.fast else 500        # default = paper's T=2,500
    n_runs = 1 if args.fast else (5 if args.full else 2)
    dev = args.device

    t_start = time.time()

    from repro_torch.benchmarks import (baselines, cache, chaos, disagg,
                                        energy_model, features, kernels,
                                        lambda_sweep, model_addition,
                                        overhead, pool_scale, prefill,
                                        routerbench, scenarios, telemetry)

    failed = []

    def section(title, fn):
        t0 = time.time()
        try:
            lines = fn()
        except Exception as e:  # noqa: BLE001 — reported, and fails main
            lines = [f"# FAILED: {type(e).__name__}: {e}"]
            failed.append(title)
        print(f"\n== {title} ({time.time() - t0:.1f}s) ==")
        print("\n".join(lines))
        sys.stdout.flush()

    section("Fig2+3: GreenServ vs baselines",
            lambda: baselines.main(per_task=per_task, device=dev))
    section("Fig4/A4: lambda sweep",
            lambda: lambda_sweep.main(per_task=max(per_task // 2, 50),
                                      n_runs=n_runs, device=dev))
    section("Fig5: feature ablation",
            lambda: features.main(per_task=max(per_task // 2, 50),
                                  n_runs=n_runs, device=dev))
    section("Featurization: host vs device throughput + decision latency",
            lambda: features.perf_main(n_iter=2 if args.fast else 5,
                                       smoke=args.fast, device=dev))
    section("Fig6: model addition",
            lambda: model_addition.main(per_task=per_task, device=dev))
    section("Table1: RouterBench",
            lambda: routerbench.main(n_per_task=max(per_task // 2, 50),
                                     device=dev))
    section("Scenario lab: flash crowd / duplicate flood / pool churn",
            lambda: scenarios.main(smoke=args.fast, artifact_prefix=None,
                                   device=dev))
    section("Table3+4: overhead",
            lambda: overhead.main(n_queries=per_task, device=dev))
    section("Telemetry: overhead + energy-budget governance",
            lambda: telemetry.main(per_task=max(per_task // 2, 60),
                                   device=dev))
    section("Chunked prefill: TTFT steps vs chunk size",
            lambda: prefill.main(
                prompt_len=48 if args.fast else 96,
                chunks=[1, 8] if args.fast else [1, 4, 8, 16], device=dev))
    section("GreenCache: hit rates + avoided joules vs --cache-mode off",
            lambda: cache.main(n_queries=36 if args.fast else 120,
                               smoke=args.fast, device=dev))
    section("Disaggregated serving: tail TTFT + joules vs monolithic",
            lambda: disagg.main(n_users=240 if args.fast else 2000,
                                smoke=args.fast, artifact=None, device=dev))
    section("Fleet: sharded-pool weak scaling under a shard kill",
            lambda: pool_scale.main(
                per_shard=100 if args.fast else 250,
                smoke=args.fast, artifact=None, device=dev))
    section("Energy cost model: forecast MAE + routing non-regression",
            lambda: energy_model.main(
                n_queries=48 if args.fast else 120, smoke=args.fast,
                artifact=None, device=dev))
    section("Chaos: reliability layer vs fault storm (goodput + breaker)",
            lambda: chaos.main(
                per_task=20 if args.fast else 60, smoke=args.fast,
                fleet=not args.fast, artifact=None, device=dev))
    section("Kernels: allclose + ref timing",
            lambda: kernels.main(device=dev))
    print(f"\n== total {time.time() - t_start:.1f}s ==")
    if failed:
        print(f"# {len(failed)} section(s) failed: {'; '.join(failed)}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
