#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s serving phase alone and after its paper phase,
on one NVIDIA GPU (written for an H100).

    python3 tools/phase_order.py [--paper]

Builds the package's kernels, then runs ``chip_smoke.paper_phase`` (with
``--paper``, freeing its routers and the card's cached memory after it, as
``chip_smoke.main`` does) and ``chip_smoke.serving_phase``, printing each
phase's wall time.  Run it in separate processes, alternating the two
forms (alone, after, after, alone), to tell whether the paper phase slows
the serving phase that follows it or the host's speed moved.  Exits
non-zero where no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paper", action="store_true",
                    help="run the paper phase before the serving phase")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_order: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = resolve_device("cuda")
    build.build()
    build.library()
    times = {}
    if args.paper:
        t = time.perf_counter()
        cs.paper_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
        times["paper_s"] = time.perf_counter() - t
    t = time.perf_counter()
    launches, engines = cs.serving_phase(dev)
    times["serve_s"] = time.perf_counter() - t
    del engines
    print(json.dumps({"paper_first": args.paper, **times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
