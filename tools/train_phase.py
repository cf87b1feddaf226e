#!/usr/bin/env python3
"""Train rwkv6-1.6b at full width on one NVIDIA GPU, as part (a) of
``chip_smoke.py``'s train phase, at each learning rate given.

    python3 tools/train_phase.py [--lr 3e-4 1e-3 ...] [--profile]

For each lr in turn: 12 steps of ``make_train_step`` at B = 8, S = 512 on
``synthetic_batches`` (``chip_smoke.train_full_width``, which prints the
losses, grad norms, ms a step, tokens a second and peak memory), then one
JSON line with the lr, the losses, whether the last is below the first,
and the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit`` gives them.  ``--profile`` then runs two
more steps on the last lr's model (fresh moments) and a third under
torch.profiler: the step's wall ms, the card's kernel ms, the number of
kernels launched and the eight longest by name.  Nothing is gated: this is
a measurement.  Exits non-zero where no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, nargs="+",
                    default=[chip_smoke.TRAIN_FULL[3]])
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device visible", file=sys.stderr)
        return 2
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    for lr in args.lr:
        model, cfg, losses, norms, _ = chip_smoke.train_full_width(dev, lr)
        print(json.dumps({"lr": lr, "losses": losses, "grad_norms": norms,
                          "falls": losses[-1] < losses[0], "card": card}),
              flush=True)
        if args.profile and lr == args.lr[-1]:
            profile_step(dev, model, cfg, lr, card)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def profile_step(dev, model, cfg, lr: float, card: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import train as tr
    from repro_torch.launch.train import synthetic_batches

    import chip_smoke

    b, s, steps, _ = chip_smoke.TRAIN_FULL
    ocfg = tr.OptConfig(lr=lr, total_steps=steps,
                        warmup_steps=min(20, steps // 5 + 1))
    data = synthetic_batches(cfg, b, s + 1, seed=1, device=dev)
    bundle = tr.make_train_step(cfg, chip_smoke._card_mesh(dev), next(data),
                                ocfg)
    opt = tr.make_opt_state(cfg, model, ocfg)
    for _ in range(2):
        model, opt, m = bundle.fn(model, opt, next(data))
        float(m["loss"])
    batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        model, opt, m = bundle.fn(model, opt, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    print(json.dumps({
        "profiled_step_wall_ms": wall, "kernel_ms": dev_ms,
        "busy_share": dev_ms / wall,
        "kernel_launches": sum(e.count for e in kernels),
        "top": [[e.key[:60], e.self_device_time_total / 1e3, e.count]
                for e in top], "card": card}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
