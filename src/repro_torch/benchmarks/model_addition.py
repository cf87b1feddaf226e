"""Paper Fig. 6 (§6.2.4): zero-calibration model addition — gemma-3-12b,
held out of the paper pool, joins at query 1,000 as a fresh bandit arm.

    PYTHONPATH=src python -m repro_torch.benchmarks.model_addition \
        [--per-task 300] [--device cpu]

runs the router on the card (``--device cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np

from repro_torch.benchmarks.common import make_router, run_policy, stream
from repro_torch.configs.pool import ADDITION_MODEL
from repro_torch.data import OutcomeSimulator


def run(per_task: int = 500, add_at: int = 1000, lam: float = 0.2,
        seed: int = 0, device=None):
    """(the replay's result, the added model's selection share before the
    addition, and from 100 queries after it to the end)."""
    qs = stream(per_task=per_task, seed=seed)
    router = make_router(lam=lam, seed=seed, exclude=[ADDITION_MODEL],
                         device=device)
    sim = OutcomeSimulator(seed=seed + 7)
    res = run_policy(router, qs, sim, "addition", add_model_at=add_at,
                     add_model_name=ADDITION_MODEL)
    new_idx = router.pool.index_of(ADDITION_MODEL)
    trace = res.selection_trace
    before = float(np.mean(trace[:add_at] == new_idx))
    after = float(np.mean(trace[add_at + 100:] == new_idx))
    return res, before, after


def main(per_task: int = 300, device=None) -> List[str]:
    res, before, after = run(per_task=per_task,
                             add_at=min(1000, per_task * 5 - 500),
                             device=device)
    lines = ["phase,selection_frequency_of_added_model"]
    lines.append(f"before_addition,{before:.4f}")
    lines.append(f"after_addition(+100 queries),{after:.4f}")
    lines.append(f"# paper: 0 before, stabilizes ~20-25% after; "
                 f"adopted={after > 0.10}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--per-task", type=int, default=300)
    ap.add_argument("--device", default=None,
                    help="the router's device (default: the card)")
    args = ap.parse_args()
    print("\n".join(main(per_task=args.per_task, device=args.device)))
