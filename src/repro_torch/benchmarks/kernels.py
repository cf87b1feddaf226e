"""Kernel micro-bench: each hand-written kernel's wrapper against its plain
PyTorch version at the JAX package's ``benchmarks/bench_kernels.py``
configs, with the plain version's time a call.

Four rows, the reference's header, kernels and configs:

  * ``flash_attention,s512_h8kv2_d64`` — bf16 (1, 512, 8 | 2, 64), window
    512, causal;
  * ``decode_attention,kv2048_h8kv2`` — bf16 q (2, 1, 8, 64) against a
    (2, 2048, 2, 64) cache, window 10,000, cache_len 1,500;
  * ``moe_gating,t2048_e60_k4`` — fp32 (2048, 60) logits, top 4;
  * ``linucb_score,m64_d128_q256`` — 64 arms, d = 128, 256 queries, α 0.1,
    A⁻¹ = L Lᵀ + I.

Each row goes through the port's ``ops`` wrapper, which launches the
hand-written kernel for CUDA tensors, and gives the plain version's
(``ref.py``) µs a call and the wrapper's largest absolute error against
it.  The inputs are drawn from a seeded generator on the device (normal
draws in fp32, cast), so they are not the JAX bench's bf16 draws and the
rows' errors are not comparable number for number.  On the CPU the
wrapper runs the plain version itself, so the error there reads 0: the
CPU row checks the plumbing, the card's row the kernel.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernels [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List

import torch

from repro_torch.device import resolve_device, sync

HEADER = "kernel,config,ref_us_per_call,max_abs_err_vs_ref"


def _time_us(fn: Callable, device: torch.device, reps: int = 3) -> float:
    """Microseconds a call of ``fn`` over ``reps`` calls after one warm-up
    call, the device synchronised before the clock is read."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e6


def run(device=None, seed: int = 0, reps: int = 3) -> List[dict]:
    """The four rows: ``kernel``, ``config``, ``ref_us`` (the plain
    version's µs a call), ``err`` (the wrapper's largest absolute error
    against it), and ``out``, ``ref`` and ``inputs`` for a caller that
    holds the row to an elementwise limit."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.linucb.ops import linucb_scores
    from repro_torch.kernels.linucb.ref import linucb_scores_ref
    from repro_torch.kernels.moe_gating.ops import topk_gating
    from repro_torch.kernels.moe_gating.ref import topk_gating_ref

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    rows = []

    def row(kernel, config, kernel_fn, plain_fn, inputs, first=None):
        out, ref = kernel_fn(), plain_fn()
        sync(dev)
        pick = first or (lambda x: x)
        err = float((pick(out).float() - pick(ref).float()).abs().max())
        rows.append(dict(kernel=kernel, config=config,
                         ref_us=_time_us(plain_fn, dev, reps), err=err,
                         out=out, ref=ref, inputs=inputs))

    bf16 = torch.bfloat16
    q, k, v = (normal(1, 512, 8, 64, dtype=bf16),
               normal(1, 512, 2, 64, dtype=bf16),
               normal(1, 512, 2, 64, dtype=bf16))
    row("flash_attention", "s512_h8kv2_d64",
        lambda: flash_attention(q, k, v, 512),
        lambda: attention_ref(q, k, v, 512), (q, k, v))

    q1 = normal(2, 1, 8, 64, dtype=bf16)
    kc, vc = normal(2, 2048, 2, 64, dtype=bf16), normal(2, 2048, 2, 64,
                                                        dtype=bf16)
    row("decode_attention", "kv2048_h8kv2",
        lambda: decode_attention(q1, kc, vc, 10_000, 1500),
        lambda: decode_attention_ref(q1, kc, vc, 10_000, 1500), (q1, kc, vc))

    logits = normal(2048, 60)
    row("moe_gating", "t2048_e60_k4", lambda: topk_gating(logits, 4),
        lambda: topk_gating_ref(logits, 4), (logits,),
        first=lambda wi: wi[0])

    lower = normal(64, 128, 128) * 0.1
    a_inv = (torch.einsum("mij,mkj->mik", lower, lower)
             + torch.eye(128, device=dev)[None])
    theta, x = normal(64, 128), normal(256, 128)
    row("linucb_score", "m64_d128_q256",
        lambda: linucb_scores(a_inv, theta, x, 0.1),
        lambda: linucb_scores_ref(a_inv, theta, x, 0.1), (a_inv, theta, x))
    return rows


def main(device=None) -> List[str]:
    lines = [HEADER]
    for r in run(device):
        digits = 4 if r["kernel"].endswith("attention") else 6
        lines.append(f"{r['kernel']},{r['config']},{r['ref_us']:.0f},"
                     f"{r['err']:.{digits}f}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="the tensors' device (default: the card)")
    args = ap.parse_args()
    print("\n".join(main(device=args.device)))
