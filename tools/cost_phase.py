#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s cost phase (phase 12) alone on one NVIDIA GPU.

    python3 tools/cost_phase.py

Builds the kernels, prints the card's name and power limit as
``nvidia-smi --query-gpu=name,power.limit`` gives them, then runs
``chip_smoke.cost_phase``: granite-3-8b at full width, the two one-card
dry-run records, the card's FLOPs against them, each step timed with
``use_pallas`` False and True against its spec floor, and the Roofline
table.  Exits non-zero where no CUDA device is visible or a check fails.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("cost_phase: no CUDA device visible", file=sys.stderr)
        return 2
    print(chip_smoke.card_line(), flush=True)
    build.build()
    build.library()
    t = time.perf_counter()
    launches = chip_smoke.cost_phase(torch.device("cuda"))
    chip_smoke.phase_done("cost", t, f"; launches {launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
