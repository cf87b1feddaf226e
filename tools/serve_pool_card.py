#!/usr/bin/env python3
"""Serve ``examples/torch_serve_pool.py`` on one NVIDIA GPU and count the
hand-written kernels it launches.

    python3 tools/serve_pool_card.py [--queries 30]

Runs the example's ``main`` on the card (its smoke configs with
``use_pallas``, weights drawn from seeds), with every kernel wrapper's
launch count set to 0 just before and read just after, and prints the
example's lines, then one JSON line: the queries answered, hedges,
restarts, seconds, each kernel's launches, and the card's name and power
limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them.  Exits
non-zero where no CUDA device is visible, a query went unanswered, or the
gating kernel never ran (qwen2-moe's top-k gate).
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

KERNELS = ("featurize", "linucb", "moe_gating", "flash_attention", "rwkv6",
           "mamba2", "decode_attention")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--queries", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    ops = {k: importlib.import_module(f"repro_torch.kernels.{k}.ops")
           for k in KERNELS}
    spec = importlib.util.spec_from_file_location(
        "torch_serve_pool", ROOT / "examples" / "torch_serve_pool.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)

    for mod in ops.values():
        mod.launches = 0
    t0 = time.perf_counter()
    run = example.main(["--queries", str(args.queries)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: mod.launches for k, mod in ops.items()}
    server = run["server"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    answered = len(server.responses)
    print(json.dumps({"queries": len(run["queries"]), "answered": answered,
                      "hedges": server.stats["hedges"],
                      "restarts": server.stats["restarts"],
                      "seconds": seconds, "launches": launches,
                      "card": card}))
    return 0 if (answered == len(run["queries"])
                 and launches["moe_gating"] > 0) else 1


if __name__ == "__main__":
    sys.exit(main())
