"""Roofline table: the dry-run records per (arch × shape) — the port of
the JAX package's ``benchmarks/roofline.py``, over the records of
``repro_torch.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline \
        [--dir experiments/dryrun_torch]

The header is the reference's.  ``tpu_est_GiB`` stays empty: meta tensors
keep bf16, so the port's dry run makes no XLA:CPU bf16-emulation estimate.
A record's status is ``OK`` (its peak fits ``HBM_PER_CHIP``), ``OOM``,
``SKIP(sub-quadratic-only)`` or ``ERROR``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
from typing import Dict, List, Optional, Sequence

DEFAULT_DIR = "experiments/dryrun_torch"


def load_records(directory: str = DEFAULT_DIR) -> List[Dict]:
    return [json.loads(p.read_text())
            for p in sorted(pathlib.Path(directory).glob("*.json"))]


def table(directory: str = DEFAULT_DIR) -> List[str]:
    lines = ["arch,shape,mesh,status,peak_GiB,tpu_est_GiB,t_compute_s,"
             "t_memory_s,t_collective_s,bottleneck,roofline_fraction,"
             "model_vs_hlo,energy_Wh_per_step"]
    for r in load_records(directory):
        head = f"{r['arch']},{r['shape']},{r.get('mesh', '-')}"
        if r.get("skipped"):
            lines.append(f"{head},SKIP(sub-quadratic-only),,,,,,,,,")
            continue
        if "error" in r:
            lines.append(f"{head},ERROR,,,,,,,,,")
            continue
        status = "OK" if r.get("fits_hbm") else "OOM"
        lines.append(
            f"{head},{status},"
            f"{r['peak_bytes_per_dev'] / 2**30:.2f},,"
            f"{r['t_compute_s']:.4g},{r['t_memory_s']:.4g},"
            f"{r['t_collective_s']:.4g},{r['bottleneck']},"
            f"{r['roofline_fraction']:.4f},{r['model_vs_hlo']:.3f},"
            f"{r['energy_wh_per_step']:.4g}")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=DEFAULT_DIR)
    args = ap.parse_args(argv)
    print("\n".join(table(args.dir)))


if __name__ == "__main__":
    main()
