#!/usr/bin/env python3
"""Time the decode-attention kernel of the PyTorch port at several split
counts on one NVIDIA GPU (written for an H100).

    python3 tools/decode_splits.py [--splits 4,6,7,8,10,12] [--repeats 2]

``kernels/decode_attention/kernel.py::layout`` picks the number of splits
of each (row, kv head) from the shapes and the card; this script replaces
that choice by each count given, at gemma3-12b's global layers in
lockstep decode (B=4, S=32768, 16/8 heads of 256, cache_len 32705, bf16),
granite-3-8b's decode shape and gemma3's ring shape, and prints per count
the kernel's time between CUDA events over back-to-back calls, its time
on the card (torch.profiler), the grid and the share of the bytes bound.
The counts are run in turns, forward then backward, ``--repeats`` times,
so that drift on the card shows as a spread.  The layout's own choice is
printed beside them.  Every output is checked against the plain version
first (one bf16 unit of the output, as ``chip_smoke.py``).  Exits
non-zero where no CUDA device is visible.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
# (name, b, s, hq, hk, hd, cache_len, window)
SHAPES = (("gemma3-12b", 4, 32768, 16, 8, 256, 32705, 32768),
          ("granite-3-8b", 4, 4096, 32, 8, 128, 4001, 4096),
          ("gemma3-12b ring", 4, 1024, 16, 8, 256, 1024, 1024))


def event_ms(fn, n: int = 100) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card_ms(fn, n: int = 30, tries: int = 3) -> float:
    """Mean time on the card per recorded launch of the decode kernel; a
    profiler session that recorded none (it can drop a session's device
    records) is run again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages()
                if "decode_attention_kernel" in e.key]
        count = sum(e.count for e in seen)
        if count:
            return sum(e.self_device_time_total for e in seen) / 1e3 / count
    raise AssertionError("the profiler recorded no decode kernel")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--splits", default="4,6,7,8,10,12")
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_splits: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.decode_attention import kernel, ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    counts = [int(c) for c in args.splits.split(",")]
    chosen = kernel.layout
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    for name, b, s, hq, hk, hd, clen, win in SHAPES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(dev, torch.bfloat16)
                   for shape in ((b, 1, hq, hd), (b, s, hk, hd),
                                 (b, s, hk, hd)))
        cl = torch.full((), clen, dtype=torch.int32, device=dev)
        w = torch.full((), win, dtype=torch.int32, device=dev)
        ref = decode_attention_ref(q, k, v, w, cl).float()
        rms = float(ref.pow(2).mean().sqrt())
        n_vis = min(clen, s) - max(clen - win, 0)
        bound_ms = ((2 * q.numel() + 2 * b * n_vis * hk * hd) * 2
                    / HBM_BYTES_PER_S * 1e3)
        default = kernel.plan(q, k)[1].n_split
        times = {n: [] for n in counts}
        for turn in range(2 * args.repeats):
            for n in counts if turn % 2 == 0 else counts[::-1]:
                kernel.layout = (lambda *a, n=n: dataclasses.replace(
                    chosen(*a), n_split=n))
                try:
                    out = ops.decode_attention(q, k, v, w, cl).float()
                    err = float(((out - ref).abs()
                                 / (2.0 ** -7 * (ref.abs() + rms))).max())
                    if not err <= 1:
                        raise AssertionError(f"{name} at {n} splits: "
                                             f"{err:.3g} of the limit")
                    call = (lambda: ops.decode_attention(q, k, v, w, cl))
                    times[n].append((event_ms(call), card_ms(call)))
                finally:
                    kernel.layout = chosen
        print(f"{name} B={b} S={s} {hq}/{hk} hd={hd} cache_len={clen} "
              f"window={win} bf16: bound {bound_ms:.6f} ms; the layout "
              f"picks {default} splits", flush=True)
        for n in counts:
            ev = [t[0] for t in times[n]]
            on_card = [t[1] for t in times[n]]
            print(f"  {n:3d} splits, {b * hk * n:5d} blocks: events "
                  f"{' '.join(f'{t:.6f}' for t in ev)} ms; on the card "
                  f"{' '.join(f'{t:.6f}' for t in on_card)} ms; "
                  f"{bound_ms / min(on_card):.3f} of the bound", flush=True)
        del q, k, v, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
