#!/usr/bin/env python3
"""Drive the PyTorch port of GreenServ on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels: the wrappers of featurize, LinUCB, MoE gating, flash
     attention, the RWKV6 WKV scan, the Mamba2 SSD scan and decode
     attention against their plain PyTorch versions on the card
     (featurize 1e-5 at the router's batches of Q = 1, 16, 64 and 256 in
     both modes, a prompt of L = 4096 and edge rows: ids past H between
     -1s, a repeated bucket, featureless rows exactly 0; LinUCB 1e-4 at
     d = 12 with the served pool's 4 arms and 64, d = 128 at Q = 1024 and
     a ragged 1000, M = 37, d = 150 and indefinite A^-1; both router
     kernels timed at the launcher and on the card, their launch
     geometry printed and held against ``layout()``; an empty kernel's
     launch as the floor beside gating; gating indices exact and weights
     1e-6,
     flash in bf16 on its tensor-core route at one bf16 unit plus the
     bound of carrying p as two bf16 parts, in fp32 on its scalar route
     at 2e-5,
     causal danube with its window included, zamba2's hd 112 and
     gemma3-12b's hd 256 at S=8192 with window 1024 and full, and exact
     mask probes (q = 0, integer v: the visible rows' mean) at hd 40, 120
     and 256 in bf16 and fp32 with windows, ragged ends and rows that see
     nothing; WKV at B=2 S=2048 H=32 and SSD at B=1
     S=4096 H=112 N=64 in the models' dtypes with y at one bf16 unit, the
     same shapes in fp32 with a nonzero initial state at 2e-4 (WKV) and
     3e-4 (SSD), a ragged S=100, S=1 and S=37, WKV with logw = -1e30
     inside a chunk and across its tiles and ends, SSD at N = 16, 32 and
     128; final states fp32 at 2e-4 / 3e-4; each scan row with its
     bytes bound, the per-token form's operations bound beside it, the
     kernel's registers, spills, shared memory, resident blocks per SM,
     grid and waves, and a check that the scan kernels' code holds
     tensor-core instructions (cuobjdump -sass);
     decode attention at gemma3's global layers B=4 S=32768 16/8 hd 256,
     granite's and zamba2's shapes, a short window, cache_len 5, a ragged
     S, gemma3's ring layers (S=1024, timed only: they attend in plain
     code) and a visible range off the kernel's tile grid, one bf16 unit
     in bf16 and 2e-5 in fp32, with the kernel's registers, resident
     blocks per SM, grid and waves) at the main paths' shapes,
     timed with CUDA events beside their bounds and, for flash and decode
     attention, PyTorch's own attention call (for flash with a boolean
     mask and, where the mask is plain causal, with ``is_causal``); the
     gating kernel also timed at its launcher, at the wrapper and on the
     card (the profiler's kernel time), beside ``torch.topk`` + softmax,
     and decode attention on the card too;
  4. router: one 64-query stream through twin routers on the card, device
     featurize vs host featurize — arms, labels, clusters and bins must be
     identical;
  5. serving: ``PoolServer`` over four full-width engines (granite-3-8b,
     rwkv6-1.6b, qwen2-moe-a2.7b, h2o-danube-3-4b; bf16,
     ``use_pallas=True``, random weights from a seed) on a synthetic
     query stream plus a decode slice of short prompts — every query
     answered, finite logits, the router kernels and the gating kernel
     launched by the main path (24 gating launches per MoE tick), real
     decode work, rwkv6 fed its prompts token-wise; a slice of the decode
     prompts goes straight into any engine the router sent fewer than 4
     queries — with three windows of the run under torch.profiler for the
     card's busy share and the top kernels;
  6. one-shot prefill: ``api.prefill`` on the four served models at full
     width (granite B=2 S=2048, danube B=1 S=6144, qwen2-moe B=2 S=2048,
     rwkv6 B=2 S=2048) through the flash kernel at every attention layer
     (every launch on its tensor-core route; the fp32 checks' on its
     scalar route),
     the gating kernel at every MoE layer and the WKV kernel at every
     RWKV layer; finite logits; qwen2-moe's one-shot logits at its first
     2 layers against its chunked prefill (S=512, in bf16 and fp32) and
     against the ``use_pallas=False`` path; rwkv6's one-shot logits at
     its first 2 layers against its token-wise ``serve_step`` (S=512, bf16
     and fp32) and against the ``use_pallas=False`` path;
  7. the hybrid, after the four engines are freed: zamba2-7b at full
     width (81 Mamba2 layers and one shared attention block at 13 sites,
     bf16, ``use_pallas=True``), ``api.prefill`` at B=1 S=4096 through the
     SSD kernel at every Mamba layer and the flash kernel at every site,
     the same one-shot vs token-wise and ``use_pallas`` checks as rwkv6,
     then a ``ModelEngine`` on the same weights serving 4 requests
     token-wise (Mamba decode and the shared block's decode at 13 sites);
  8. gemma3-12b at full width (48 layers, 5:1 local:global, window 1024,
     hd 256, bf16, ``use_pallas=True``), after zamba2 is freed:
     ``api.prefill`` at B=1 S=8192 through the flash kernel at every
     layer; lockstep decode — ``api.init_cache(cfg, 4, 32768)`` (rings for
     the 40 local layers, full-depth caches for the 8 global ones) filled
     with seeded random values, ``cache["length"]`` a 0-d 32704, 32
     ``serve_step``s through the decode-attention kernel at every global
     layer (8 launches a step); at the first 6 layers (5 rings and a
     global layer) ``use_pallas`` True vs False on the filled caches, and
     in one-layer views of that group (its first ring layer, its global
     layer) a 1536-token lockstep feed into a 2048-deep cache (the ring
     wraps; the kernel runs every step) against one-shot ``api.forward``,
     each in bf16 (0.05 of the logit range) and fp32 (1e-4), the feed's
     largest per-position gap at 0.1 (bf16) and 1e-3 (fp32); the
     full-depth gaps printed; then a ``ModelEngine`` at ``max_len`` 2048
     (rings) serving
     4 requests token-wise;
  9. engine cross-check: two full-width granite layers, bf16 against fp32
     on the same weights.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
CUDA device is visible or the package is not beside this script.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

FEATURIZE_TOL = 1e-5           # tests/test_kernels.py's featurize tolerance
LINUCB_TOL = 1e-4              # and its LinUCB tolerance
GATING_TOL = 1e-6              # its gating weight tolerance (indices exact)
FLASH_FP32_TOL = 2e-5          # its fp32 flash tolerance (atol and rtol)
# flash in bf16, as a share of |ref| plus the output's RMS: one bf16 unit
# in the last place (at most 2^-7 of |ref|; the RMS term covers outputs
# near 0).  The scalar route and the plain version both accumulate in fp32
# and round the output to bf16 once, so they differ by at most that.  The
# tensor-core route (kernel.route "wgmma") also carries each p into the
# product with v as two bf16 parts, hi = bf16(p) and lo = bf16(p - hi): a
# relative error of at most 2^-16 per p, so an output moves by at most
# 2^-16 sum_j p_j |v_j| / l, which is 2^-16 of the plain version run on
# |v| (FLASH_P_REL below); its bf16 cases are held at FLASH_BF16_REL
# (|ref| + RMS) + FLASH_P_REL attention_ref(q, k, |v|), a bound from the
# design, not a fit to a measured error.  All of it is far
# inside tests/test_kernels.py's 3e-2, which is about as large as a
# typical output here (|out| ~ sqrt(e/n) for n visible keys: 0.03 at
# n = 2048): a dropped kv tile moves outputs by the order of their RMS
# and fails it.  An off-by-one of the window or the diagonal moves an
# output by ~1/n of a value, below that limit: the exact probes
# (FLASH_PROBE_SHAPES) and the fp32 causal danube case hold it.
FLASH_BF16_REL = 2.0 ** -7
FLASH_P_REL = 2.0 ** -16
# the exact mask probes: q = 0, so every visible p is exactly 1 (also in
# bf16), and v integers in [-4, 4], so every path computes the mean of the
# visible rows of v exactly and rounds it once (tests/test_torch_flash_
# route.py pins that on the CPU); bf16 held at FLASH_BF16_REL |ref| + 1e-6,
# fp32 at FLASH_FP32_TOL.  A leak of one position across the diagonal or
# the window's edge moves an output by about 1/n of a value.  hd 40 (not a
# multiple of 16, the narrow tile), 120 and 256 (the wide tile); windows,
# ragged ends and rows past Sk + window that see nothing put edges across
# the kv tiles of both tile configurations
# (b, sq, sk, hq, hk, window, causal) x hd x dtype
FLASH_PROBE_SHAPES = ((2, 333, 333, 4, 2, 77, True),
                      (2, 200, 333, 4, 2, 150, False),
                      (2, 333, 130, 4, 2, 64, False))
FLASH_PROBE_HDS = (40, 120, 256)
# bf16 vs fp32 logits of the same two layers, as a share of the fp32 logit
# range.  bf16 keeps 8 significant bits (unit roundoff 2^-9), but with the
# reference's init rule q and k reach magnitudes of 10-20 at d_model 4096,
# so attention scores are O(100) and the softmax is nearly one-hot: one
# bf16 rounding of q or k (about one unit of score) can shift weight
# between keys and move a logit by several percent of the range.  The
# check exists to catch a broken bf16 path (garbage or NaN: errors of the
# order of the range itself), so it allows a quarter of the range.
BF16_REL_TOL = 0.25
# qwen2-moe's one-shot prefill against its chunked prefill and against the
# use_pallas=False path, at the model's first PREFILL_CHECK_DEPTH layers
# (weights shared with the served engine), as a share of the logit range;
# rwkv6's and zamba2's one-shot prefill against their token-wise
# serve_step and against use_pallas=False, at the same depth and limits
# (the same reasons: the paths round to bf16 at different places, and the
# recurrent models' one-shot scan and their decode step differ in the
# order of their fp32 sums).
# With random weights the stack is chaotic: a rounding gap moves a router
# logit across a near-tie, the token goes to another expert, and attention
# spreads that to every later token, so at full depth the paths differ by
# the order of the range even in fp32 (PERF.md, PR 12).  At 2 layers the
# bf16 gaps read 0.0045 (chunked) and 0.0217 (use_pallas False); the paths
# round q, scores and outputs to bf16 at different places and bf16
# index_add_ adds in a varying order, so bf16 is held at 0.05.  The same
# one-shot vs chunked comparison in fp32 on the same weights reads 9.2e-6
# and is held at 1e-4.
PREFILL_CHECK_DEPTH = 2
PREFILL_REL_TOL = 0.05
PREFILL_FP32_REL_TOL = 1e-4
# the WKV and SSD scans in fp32, against their plain versions: the
# tolerances of tests/test_kernels.py for the Pallas kernels (atol and
# rtol); the per-token form and the plain recurrence sum in other orders
WKV_FP32_TOL = 2e-4
SSD_FP32_TOL = 3e-4
# the router kernels' shapes: featurize (mode, Q) as route_batch pads
# them (mode "both" doubles the rows), and LinUCB (M, d, Q): the served
# pool's 4 arms and 64 at the router's d = 12, the production shape of the
# JAX kernel's docstring (src/repro/kernels/linucb/kernel.py:12-13) and a
# ragged Q, an odd M, d = 150 (two column passes); the rows whose launch
# geometry is printed and held against layout()
FEATURIZE_SHAPES = (("both", 1), ("both", 16), ("both", 64), ("both", 256),
                    ("full", 1), ("full", 16), ("full", 64))
FEATURIZE_GEOMETRY_ROWS = ("mode=both Q=1", "mode=both Q=64",
                           "mode=both Q=256")
LINUCB_SHAPES = ((4, 12, 1), (64, 12, 1), (64, 12, 16), (64, 12, 64),
                 (64, 128, 1024), (64, 128, 1000), (37, 128, 3),
                 (16, 150, 64))
LINUCB_GEOMETRY_ROWS = ("M=4 d=12 Q=1", "M=64 d=128 Q=1024")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
MOE_ARCH = "qwen2-moe-a2.7b"
RWKV_ARCH = "rwkv6-1.6b"
HYBRID_ARCH = "zamba2-7b"
GEMMA_ARCH = "gemma3-12b"
# the serving launcher's default pool, in its order, and danube: arms that
# are untried tie, ties go to the lowest index, and an arm late in the
# pool may get no query from an 80-query stream (rwkv6 got none as the
# fourth arm)
SERVE_ARCHS = ("granite-3-8b", RWKV_ARCH, MOE_ARCH, "h2o-danube-3-4b")
# the router phase's pool profiles: (family, billions of parameters)
ARCH_PROFILES = {"granite-3-8b": ("dense", 8.2), RWKV_ARCH: ("rwkv", 1.3),
                 MOE_ARCH: ("moe", 14.3), "h2o-danube-3-4b": ("dense", 4.0)}
SERVE_MAX_LEN = 192            # the serving launcher's max_len and
SERVE_CHUNK = 8                # prefill_chunk (rwkv6's clamps to 1)
PROFILE_STEPS = 5              # scheduler steps per profiled window
MOE_MIN_DECODE_TICKS = 16      # below this, a decode slice goes straight
                               # into the MoE engine after the pool drains
MIN_ROUTED = 4                 # and into any engine the router sent fewer
                               # queries: with every model's accuracy 0
                               # (random weights), the bandit settles on
                               # the cheapest arm
# one-shot prefill at full width: (arch, batch, sequence)
PREFILL_CASES = (("granite-3-8b", 2, 2048), ("h2o-danube-3-4b", 1, 6144),
                 (MOE_ARCH, 2, 2048), (RWKV_ARCH, 2, 2048))
HYBRID_PREFILL = (1, 4096)     # zamba2-7b's one-shot prefill (batch, seq)
TOKENWISE_S = 512              # prompt length of the one-shot vs token-wise
                               # checks (first PREFILL_CHECK_DEPTH layers)
TOKENWISE_FULL_S = 128         # and of the full-depth gaps, printed
HYBRID_REQUESTS = (4, 32, 16)  # zamba2 engine: requests, prompt, new tokens
# flash kernel shapes: the four prefills' attention (window as
# ``layer_windows`` gives it; zamba2's shared block at window S), danube's
# again in fp32 (the causal and window masks at a tight tolerance) and one
# non-causal fp32 shape
# (name, b, sq, sk, hq, hk, hd, window, causal, dtype)
FLASH_CASES = (
    ("granite-3-8b", 2, 2048, 2048, 32, 8, 128, 2048, True, torch.bfloat16),
    ("h2o-danube-3-4b", 1, 6144, 6144, 32, 8, 120, 4096, True,
     torch.bfloat16),
    (MOE_ARCH, 2, 2048, 2048, 16, 16, 128, 2048, True, torch.bfloat16),
    (HYBRID_ARCH, 1, 4096, 4096, 32, 32, 112, 4096, True, torch.bfloat16),
    ("h2o-danube-3-4b fp32", 1, 6144, 6144, 32, 8, 120, 4096, True,
     torch.float32),
    ("non-causal", 1, 512, 768, 8, 2, 120, 640, False, torch.float32),
    # gemma3-12b's prefill: hd 256 (the wide tile), local and global layers
    (GEMMA_ARCH + " local", 1, 8192, 8192, 16, 8, 256, 1024, True,
     torch.bfloat16),
    (GEMMA_ARCH + " global", 1, 8192, 8192, 16, 8, 256, 8192, True,
     torch.bfloat16),
    (GEMMA_ARCH + " local fp32", 1, 8192, 8192, 16, 8, 256, 1024, True,
     torch.float32),
    (GEMMA_ARCH + " global fp32", 1, 8192, 8192, 16, 8, 256, 8192, True,
     torch.float32),
)
# decode attention: gemma3's global layers in lockstep decode (the main
# path's shape: B=4 at cache_len 32705 of 32768, full window), the same in
# fp32, granite's and zamba2's shapes, a window shorter than cache_len,
# cache_len 5 (one tile: the other splits of each (row, kv head) see
# nothing), a ragged S, gemma3's ring layers as attention_decode_ring
# holds them (a full ring of its window 1024; timed, not dispatched to),
# and gemma3's shape with a visible range that starts and ends off the
# kernel's tile grid (the kernel cuts its splits from the visible range,
# so cache_len always ends the last split: its last tile is ragged,
# loaded row by row)
# (name, b, s, hq, hk, hd, cache_len, window, dtype)
DECODE_CASES = (
    (GEMMA_ARCH, 4, 32768, 16, 8, 256, 32705, 32768, torch.bfloat16),
    (GEMMA_ARCH + " fp32", 4, 32768, 16, 8, 256, 32705, 32768,
     torch.float32),
    ("granite-3-8b", 4, 4096, 32, 8, 128, 4001, 4096, torch.bfloat16),
    (HYBRID_ARCH, 1, 4096, 32, 32, 112, 4001, 4096, torch.bfloat16),
    ("window 1024", 4, 32768, 16, 8, 256, 32705, 1024, torch.float32),
    ("cache_len 5", 4, 32768, 16, 8, 256, 5, 32768, torch.float32),
    ("ragged S", 2, 5000, 8, 2, 128, 4999, 5000, torch.float32),
    (GEMMA_ARCH + " ring", 4, 1024, 16, 8, 256, 1024, 1024, torch.bfloat16),
    ("ragged window", 4, 32768, 16, 8, 256, 16389, 8195, torch.bfloat16),
)
# fp32 cases at tests/test_kernels.py's 2e-5 (atol and rtol); bf16 cases at
# one bf16 unit, as flash (FLASH_BF16_REL): test_kernels.py's 3e-2 is about
# three typical outputs here (|out| ~ 0.01 over 32k random keys), so a
# kernel that wrote zeros would pass it
DECODE_FP32_TOL = 2e-5
# gemma3-12b's phase: one-shot prefill (batch, seq); lockstep decode at
# (batch, cache depth, starting length, steps); the first-group checks'
# depth, feed length and cache depth; the full-depth feed's length; the
# engine (requests, prompt, new tokens) at max_len 2048
GEMMA_PREFILL = (1, 8192)
GEMMA_DECODE = (4, 32768, 32704, 32)
GEMMA_CHECK_DEPTH = 6
GEMMA_FEED = (1536, 2048)
GEMMA_FULL_FEED = 64
# the one-layer feeds' largest per-position logit gap, as a share of the
# logit range: one layer at full width with random weights amplifies
# rounding at single positions (r3/r4 of PR 14 read 0.048 / 0.041 in bf16
# and 2.2e-4 / 2.0e-4 in fp32, the medians past the window 0.0045 and
# 1.2e-5), so the maxima are held at about twice (bf16) and five times
# (fp32) those readings: a fault at a few positions (one ring slot after
# the wrap, one split boundary of the decode kernel) fails it even where
# the median does not move
GEMMA_FEED_MAX_TOL = {"bf16": 0.1, "fp32": 1e-3}
GEMMA_PROFILE_STEPS = 4         # lockstep steps profiled after the main run
GEMMA_REQUESTS = (4, 32, 16)
GEMMA_ENGINE_MAX_LEN = 2048
GATING_T = (4, 32, 4096)       # decode tick, chunk tick (4 x 8), a prefill
# WKV shapes: rwkv6's prefill (B, S, H), its dtypes (r, k, v bf16; logw, u
# and the zero initial state fp32, as forward_hidden passes them), then
# the same in fp32 with a nonzero initial state, then a ragged S, S = 1
# and S = 37 (one ragged chunk), and a row with logw = -1e30 moved
# mid-sequence: inside a chunk, across the kernel's 8-token decay blocks
# and 16-token tiles, and across a chunk's end.  Every row also has -1e30
# at tokens 0-3 of head 0, channels 0-7.
# (name, b, s, h, dtype, initial state, further (tokens, channels) at
# -1e30)
WKV_CASES = ((RWKV_ARCH, 2, 2048, 32, torch.bfloat16, "zeros", ()),
             ("fp32", 2, 2048, 32, torch.float32, "random", ()),
             ("ragged", 1, 100, 3, torch.float32, "random", ()),
             ("S=1", 2, 1, 3, torch.bfloat16, "random", ()),
             ("S=37", 1, 37, 4, torch.float32, "random", ()),
             ("-1e30 mid-sequence", 1, 300, 4, torch.float32, "random",
              ((slice(100, 103), slice(0, 8)),
               (slice(134, 139), slice(8, 24)),
               (slice(142, 146), slice(40, 48)),
               (slice(190, 194), slice(0, 64)))))
# SSD shapes: zamba2's prefill (B, S, H, N) in its dtypes (x, B, C bf16;
# dt and A fp32; no initial state, as mamba_prefill passes it), the same
# in fp32 with a nonzero initial state, then a ragged S, S = 1, S = 37
# (one ragged chunk), and the other state sizes the kernel takes at
# ragged S (N = 128 in fp32 takes the half-head layout)
# (name, b, s, h, n, dtype, initial state)
SSD_CASES = ((HYBRID_ARCH, 1, 4096, 112, 64, torch.bfloat16, None),
             ("fp32", 1, 4096, 112, 64, torch.float32, "random"),
             ("ragged", 2, 100, 3, 64, torch.float32, "random"),
             ("S=1", 2, 1, 3, 64, torch.bfloat16, "random"),
             ("S=37", 1, 37, 5, 64, torch.float32, "random"),
             ("N=16", 1, 77, 2, 16, torch.bfloat16, None),
             ("N=32", 1, 130, 2, 32, torch.float32, "random"),
             ("N=128", 1, 70, 2, 128, torch.float32, "random"))


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, n: int = 200, budget_s: float = 0.5) -> float:
    """Mean milliseconds per call of ``fn`` over back-to-back calls,
    between two CUDA events, after a warm-up: ``n`` calls, or fewer (at
    least 3) where ``n`` would take longer than ``budget_s``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = max(3, min(n, int(budget_s / max(time.perf_counter() - t, 1e-9))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, kernel_name: str, n: int = 30, tries: int = 3):
    """Mean milliseconds per launch that the card spent in a kernel whose
    name holds ``kernel_name``, from torch.profiler's device activity over
    ``n`` calls of ``fn`` after a warm-up: the kernel's own time, without
    the host's time to issue it.  The mean is over the launches that the
    profiler recorded: it can drop some or all of a session's device
    records, so a session that recorded none is run again, up to
    ``tries`` times, and then this returns None (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.key_averages() if kernel_name in e.key]
        count = sum(e.count for e in seen)
        if count:
            return sum(e.self_device_time_total for e in seen) / 1e3 / count
    return None


def ms_text(ms) -> str:
    return "not measured" if ms is None else f"{ms:.6f} ms"


def bound(n_bytes: float, n_ops: float, flops: float = FP32_FLOPS) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take,
    with ``flops`` the peak rate for the operations' type."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _ops_modules() -> dict:
    from repro_torch.kernels.featurize import ops as featurize_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.linucb import ops as linucb_ops
    from repro_torch.kernels.mamba2 import ops as mamba2_ops
    from repro_torch.kernels.moe_gating import ops as gating_ops
    from repro_torch.kernels.decode_attention import ops as decode_ops
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    return {"featurize": featurize_ops, "linucb": linucb_ops,
            "moe_gating": gating_ops, "flash_attention": flash_ops,
            "rwkv6": rwkv6_ops, "mamba2": mamba2_ops,
            "decode_attention": decode_ops}


def reset_launches() -> None:
    """Every wrapper's launch count to 0 (just before a path is driven),
    flash's count of tensor-core launches too."""
    for mod in _ops_modules().values():
        mod.launches = 0
    _ops_modules()["flash_attention"].wgmma_launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in _ops_modules().items()}


def check_flash_route(what: str, want: str) -> int:
    """The flash launches since the last reset all took route ``want``:
    "wgmma" (each one counted in ``wgmma_launches``; every bf16 launch of
    a model path) or "scalar" (none of them; fp32).  Returns the count."""
    flash = _ops_modules()["flash_attention"]
    n, w = flash.launches, flash.wgmma_launches
    if w != (n if want == "wgmma" else 0):
        raise AssertionError(f"{what}: {w} of {n} flash launches on the "
                             f"wgmma route, expected route {want}")
    return n


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def featurize_cases(dev) -> list:
    """(label, ids, weights, proj) on the card: the router's batches as
    ``route_batch`` pads them (mode "both": the full texts then the
    instruction slices; "full": the texts alone) at Q = 1, 16, 64 and 256
    (512 rows), with a featureless row (" ") at index 1 of every batch of
    more than one; one prompt of 2,049-4,096 features (L = 4096); and an
    edge batch: ids at and past H interleaved with -1, one bucket repeated
    (its count 5.25), a featureless row, a row of every kind at once."""
    from repro_torch.core.context import ContextGenerator
    from repro_torch.core.types import RouterConfig
    from repro_torch.data.stream import make_stream
    from repro_torch.kernels.featurize import ops

    ctx = ContextGenerator(RouterConfig(), device=dev)
    proj = ctx.embedder.proj_device(dev)
    h = proj.shape[0]
    stream = [q.text for q in make_stream(per_task=52, seed=21)]
    cases = []
    for mode, q in FEATURIZE_SHAPES:
        texts = stream[:q]
        if q > 1:
            texts[1] = " "                           # a featureless row
        ids, w = ctx.padded_feature_tensors(
            texts, want_full=True, want_instr=mode == "both",
            q_pad=ops.pad_pow2(q))
        cases.append((f"mode={mode} Q={q}", ids, w))
    long_text, n = "", 0
    for t in stream:
        long_text += " " + t
        n = ctx.embedder.hashed_features([long_text])[0].shape[1]
        if n > 2048:
            break
    ids, w = ctx.padded_feature_tensors([long_text], want_full=True,
                                        want_instr=False, q_pad=1)
    cases.append((f"one prompt, {n} features", ids, w))
    rng = np.random.default_rng(23)
    ids = np.full((4, 128), -1, np.int32)
    w = np.zeros((4, 128), np.float32)
    wts = np.array([1.0, 0.5, 0.75], np.float32)
    ids[0, 0::4] = rng.integers(0, h, 32)            # valid ids,
    ids[0, 1::4] = h + rng.integers(0, 5000, 32)     # ids past H,
    ids[0, 2::4] = h                                 # the first id past H
    w[0] = rng.choice(wts, 128)                      # and -1 between
    ids[1, :8] = 7                                   # one bucket 8 times
    w[1, :8] = [1.0, 0.75, 0.5, 0.5, 0.75, 1.0, 0.75, 0.0]
    ids[1, 8:40] = rng.integers(0, h, 32)
    w[1, 8:40] = rng.choice(wts, 32)
    ids[3] = np.where(rng.random(128) < 0.5, rng.integers(-1, h + 3, 128),
                      7)
    w[3] = rng.choice(wts, 128)                      # row 2: no features
    cases.append(("edge rows", ids, w))
    return [(label, torch.from_numpy(i).to(dev), torch.from_numpy(x).to(dev),
             proj) for label, i, x in cases]


def featurize_bound(ids, proj) -> tuple:
    """What this data needs of the card, (ms, what bounds it).  Bytes: ids
    and weights read once, the output written once, and of the projection
    only the rows of buckets that some row of the batch hits (the kernel
    reads no other).  Operations: a multiply-add per (row, non-zero bucket,
    column), the scatter, log1p, the norm."""
    rows, h = ids.shape[0], proj.shape[0]
    ok = (ids >= 0) & (ids < h)
    nnz = int((torch.zeros(rows, h, device=ids.device)
               .scatter_add_(1, ids.long().clamp(0, h - 1), ok.float())
               > 0).sum())
    hit = int(torch.unique(ids[ok]).numel())
    n_bytes = (2 * ids.numel() + hit * proj.shape[1]
               + rows * proj.shape[1]) * 4
    n_ops = (2 * nnz * proj.shape[1] + ids.numel()
             + rows * (h + 3 * proj.shape[1]))
    return bound(n_bytes, n_ops) + (hit, nnz)


def featurize_phase(dev) -> dict:
    from repro_torch.kernels.featurize import kernel, ops
    from repro_torch.kernels.featurize.ref import hashed_embed_ref

    rows, worst = [], 0.0
    for label, ids_d, w_d, proj in featurize_cases(dev):
        out = ops.hashed_embed(ids_d, w_d, proj)
        ref = hashed_embed_ref(ids_d, w_d, proj)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= FEATURIZE_TOL:
            raise AssertionError(f"featurize {label}: max abs err {err} > "
                                 f"{FEATURIZE_TOL}")
        empty = ((ids_d < 0) | (ids_d >= proj.shape[0])).all(dim=1)
        if not (bool((out[empty] == 0).all()) and torch.isfinite(out).all()):
            raise AssertionError(f"featurize {label}: a featureless row is "
                                 f"not exactly zero, or an output is not "
                                 f"finite")
        worst = max(worst, err)
        ms = cuda_ms(lambda: kernel.hashed_embed_fwd(ids_d, w_d, proj))
        dev_ms = device_ms(lambda: kernel.hashed_embed_fwd(ids_d, w_d, proj),
                           "featurize_kernel")
        plain_ms = cuda_ms(lambda: hashed_embed_ref(ids_d, w_d, proj))
        b_ms, b_by, hit, nnz = featurize_bound(ids_d, proj)
        q, seq_l = ids_d.shape
        lay = kernel.layout(q, seq_l, *proj.shape)
        rows.append(dict(label=label, rows=q, l=seq_l, err=err, ms=ms,
                         device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by))
        log("kernels", f"featurize {label} ({q}x{seq_l} ids, {hit} buckets "
            f"hit, {nnz} row-bucket pairs, {int(empty.sum())} featureless): "
            f"err {err:.3g}, launcher {ms:.6f} ms, device {ms_text(dev_ms)}, "
            f"plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
        if label in FEATURIZE_GEOMETRY_ROWS:
            geometry_check(f"featurize {label}", lay,
                           kernel.info(q, *proj.shape, lay),
                           dict(grid=lay.grid, cluster=lay.cluster,
                                threads=lay.threads, smem=lay.smem))
    return {"rows": rows, "worst": worst}


def geometry_check(what: str, lay, info, want: dict) -> None:
    """Print a kernel's launch geometry and what the card says of it
    (registers, spills, resident blocks), and hold the C launcher's own
    grid, threads, cluster and shared memory against ``layout()``'s."""
    got = dict(grid=info.grid, threads=info.threads, smem=info.dynamic_smem)
    if "cluster" in want:
        got["cluster"] = info.cluster
    if got != want:
        raise AssertionError(f"{what}: the launcher's geometry {got} is not "
                             f"the layout's {want}")
    log("kernels", f"{what} geometry: {lay}; {info.registers} registers a "
        f"thread, {info.local_bytes} bytes spilled, {info.static_smem} "
        f"static + {info.dynamic_smem} dynamic bytes of shared memory, "
        f"{info.blocks_per_sm} resident blocks an SM of {info.n_sm}")


def linucb_cases() -> list:
    """(label, A^-1, theta, x) in numpy, seeded: the router's one-hot
    contexts at d = 12 (the served pool's M = 4 and the batch path's M =
    64), the docstring's production shape (M = 64, d = 128, Q = 1024) and
    a ragged Q = 1000, an odd M = 37, d = 150 (two column passes), and an
    indefinite A^-1 whose quadratic forms clamp to 0."""
    rng = np.random.default_rng(5)
    cases = []
    for m, d, q in LINUCB_SHAPES:
        low = rng.standard_normal((m, d, d)).astype(np.float32) * 0.2
        a_inv = np.einsum("mij,mkj->mik", low, low) + np.eye(d)[None]
        theta = rng.standard_normal((m, d)).astype(np.float32)
        if d == 12:                      # the router's one-hot contexts
            x = np.zeros((q, d), np.float32)
            x[np.arange(q), rng.integers(0, 5, q)] = 1.0
            x[np.arange(q), 5 + rng.integers(0, 3, q)] = 1.0
            x[np.arange(q), 8 + rng.integers(0, 3, q)] = 1.0
            x[:, -1] = 1.0
        else:
            x = rng.standard_normal((q, d)).astype(np.float32)
        cases.append((f"M={m} d={d} Q={q}", a_inv, theta, x))
    for d in (12, 128):                  # -A^-1: every form < 0, clamped
        m, q = 8, 16
        low = rng.standard_normal((m, d, d)).astype(np.float32) * 0.2
        a_inv = -(np.einsum("mij,mkj->mik", low, low) + np.eye(d)[None])
        cases.append((f"indefinite M={m} d={d} Q={q}", a_inv,
                      rng.standard_normal((m, d)).astype(np.float32),
                      rng.standard_normal((q, d)).astype(np.float32)))
    return [(label, *(np.ascontiguousarray(v, np.float32) for v in arrs))
            for label, *arrs in cases]


def linucb_phase(dev) -> dict:
    from repro_torch.kernels.linucb import kernel, ops
    from repro_torch.kernels.linucb.ref import linucb_scores_ref

    rows, worst = [], 0.0
    for label, *arrs in linucb_cases():
        a_d, t_d, x_d = (torch.from_numpy(v).to(dev) for v in arrs)
        m, d, _ = a_d.shape
        out = ops.linucb_scores(a_d, t_d, x_d, 0.1)
        ref = linucb_scores_ref(a_d, t_d, x_d, 0.1)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= LINUCB_TOL:
            raise AssertionError(f"linucb {label}: max abs err {err} > "
                                 f"{LINUCB_TOL}")
        worst = max(worst, err)
        # the launcher at the wrapper's padded Q
        q = ops.pad_pow2(x_d.shape[0])
        xp = torch.nn.functional.pad(x_d, (0, 0, 0, q - x_d.shape[0]))
        ms = cuda_ms(lambda: kernel.linucb_scores_fwd(a_d, t_d, xp, 0.1))
        dev_ms = device_ms(lambda: kernel.linucb_scores_fwd(a_d, t_d, xp, 0.1),
                           "linucb")
        plain_ms = cuda_ms(lambda: linucb_scores_ref(a_d, t_d, xp, 0.1))
        n_bytes = (m * d * d + m * d + q * d + q * m) * 4
        n_ops = q * m * (2 * d * d + 2 * d + 4)
        b_ms, b_by = bound(n_bytes, n_ops)
        lay = kernel.layout(q, m, d)
        rows.append(dict(label=label, m=m, d=d, q=x_d.shape[0], err=err,
                         ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by))
        log("kernels", f"linucb {label} (padded Q {q}, {lay.path} path): err "
            f"{err:.3g}, launcher {ms:.6f} ms, device {ms_text(dev_ms)}, "
            f"plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by}), "
            f"{n_ops / ms / 1e9:.3f} TFLOP/s at the launcher")
        if label in LINUCB_GEOMETRY_ROWS:
            geometry_check(f"linucb {label}", lay,
                           kernel.info(q, m, d, lay),
                           dict(grid=lay.grid, threads=lay.threads,
                                smem=lay.smem))
    return {"rows": rows, "worst": worst}


def gating_phase(dev) -> dict:
    """The gating kernel against its plain version.  Timed three ways: the
    launcher (``kernel.topk_gating_fwd``: the ctypes call and two
    allocations, as the router kernels are timed), the wrapper the main
    path calls (``ops.topk_gating``: also the fp32 cast and
    ``.contiguous()``), and, for the untied rows, the kernel's own device
    time from the profiler; beside them ``torch.topk`` then ``softmax``,
    two library calls that together compute the same function."""
    from repro_torch.kernels.moe_gating import kernel, ops
    from repro_torch.kernels.moe_gating.ref import topk_gating_ref

    rng = np.random.default_rng(13)
    e, k = 60, 4
    rows, worst = [], 0.0
    cases = [(t, False) for t in GATING_T] + [(GATING_T[-1], True)]
    for t, tied in cases:
        x = rng.standard_normal((t, e)).astype(np.float32)
        if tied:     # quantized: many exact ties, and whole rows equal
            x = np.round(x * 2) / 2 + 0.0
            x[::7] = 0.5
        logits = torch.from_numpy(x).to(dev)
        w, i = ops.topk_gating(logits, k)
        rw, ri = topk_gating_ref(logits, k)
        torch.cuda.synchronize()
        if not torch.equal(i, ri):
            bad = (i != ri).any(dim=1).nonzero()[:8, 0].tolist()
            raise AssertionError(f"gating T={t} tied={tied}: indices differ "
                                 f"from the plain version at rows {bad}")
        err = float((w - rw).abs().max())
        if not err <= GATING_TOL:
            raise AssertionError(f"gating T={t}: max abs err {err} > "
                                 f"{GATING_TOL}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: kernel.topk_gating_fwd(logits, k))
        wrapper_ms = cuda_ms(lambda: ops.topk_gating(logits, k))
        dev_ms = (None if tied else
                  device_ms(lambda: kernel.topk_gating_fwd(logits, k),
                            "moe_gating_kernel"))

        def topk_softmax():
            top = torch.topk(logits, k, dim=-1)
            return torch.softmax(top.values, dim=-1), top.indices

        topk_ms = cuda_ms(topk_softmax)
        plain_ms = cuda_ms(lambda: topk_gating_ref(logits, k))
        # bytes: the logits read once, weights and indices written once
        b_ms, b_by = bound(t * e * 4 + t * k * 8, 0)
        rows.append(dict(t=t, tied=tied, err=err, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        on_card = "" if tied else f", device {ms_text(dev_ms)}"
        log("kernels", f"moe_gating T={t} E={e} k={k}{' tied' if tied else ''}"
            f": indices equal, weight err {err:.3g}, launcher {ms:.6f} ms"
            f"{on_card}, wrapper {wrapper_ms:.6f} ms, topk + softmax "
            f"{topk_ms:.6f} ms, plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
    floor_ms = cuda_ms(empty_launch)
    floor_dev = device_ms(empty_launch, "empty_kernel")
    log("kernels", f"launch floor (an empty kernel through the same ctypes "
        f"path): launcher {floor_ms:.6f} ms, device {ms_text(floor_dev)}; "
        f"moe_gating T=4 on the card {ms_text(rows[0]['device_ms'])}")
    return {"rows": rows, "worst": worst}


def empty_launch() -> None:
    """One launch of the empty kernel (``csrc/empty.cu``) on the current
    stream: what any launch through the ctypes path costs."""
    from repro_torch.kernels import build
    build.check(build.library().empty_launch(
        torch.cuda.current_stream().cuda_stream), "empty")


def visible_pairs(sq: int, sk: int, window: int, causal: bool) -> int:
    """(q, k) pairs the mask leaves visible: k > q - window, k <= q when
    causal, positions from 0."""
    q = np.arange(sq, dtype=np.int64)
    lo = np.maximum(0, q - window + 1)
    hi = np.minimum(q + 1, sk) if causal else np.full(sq, sk)
    return int(np.maximum(hi - lo, 0).sum())


def flash_phase(dev) -> dict:
    from repro_torch.kernels.flash_attention import kernel, ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(9)
    rows, worst = [], 0.0
    for name, b, sq, sk, hq, hk, hd, win, causal, dt in FLASH_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(dev, dt) for shape in ((b, sq, hq, hd), (b, sk, hk, hd),
                                              (b, sk, hk, hd)))
        route = kernel.route(dt, hd)
        out = ops.flash_attention(q, k, v, win, causal)
        ref = attention_ref(q, k, v, win, causal).float()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        rms = float(ref.pow(2).mean().sqrt())
        if dt == torch.bfloat16:
            limit, what = FLASH_BF16_REL * (ref.abs() + rms), \
                f"{FLASH_BF16_REL} of |ref| + RMS {rms:.4g}"
            if route == "wgmma":         # p carried as two bf16 parts
                limit += FLASH_P_REL * attention_ref(
                    q.float(), k.float(), v.float().abs(), win, causal)
                what += f" + {FLASH_P_REL} of the plain version on |v|"
        else:
            limit, what = FLASH_FP32_TOL * (1 + ref.abs()), \
                f"{FLASH_FP32_TOL} (atol and rtol)"
        worst_ratio = float((diff / limit).max())
        if not (torch.isfinite(out).all() and worst_ratio <= 1):
            raise AssertionError(f"flash {name}: max abs err {err}, "
                                 f"{worst_ratio:.3g} of the limit {what}")
        worst = max(worst, err)
        # PyTorch's own attention call on the same inputs and mask, as the
        # yardstick: (B, H, S, hd) layout, GQA by enable_gqa.  A boolean
        # mask keeps it off its flash backend; where the mask is plain
        # causal (Sq = Sk, the window covering S) is_causal puts it there,
        # and the faster of the two is library_ms
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        qp = torch.arange(sq, device=dev)[:, None]
        kp = torch.arange(sk, device=dev)[None, :]
        mask = kp > qp - win
        if causal:
            mask &= kp <= qp
        yardsticks = {"mask": lambda: torch.nn.functional
                      .scaled_dot_product_attention(qt, kt, vt,
                                                    attn_mask=mask,
                                                    enable_gqa=True)}
        if causal and sq == sk and win >= sq:
            yardsticks["is_causal"] = lambda: (
                torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True))
        # a check that each yardstick computes the same function (a mask
        # mistake would be of the order of the outputs), at the bf16
        # tolerance for both dtypes: its fp32 path may round through TF32
        lib_err = max(float((fn().transpose(1, 2).float() - ref).abs().max())
                      for fn in yardsticks.values())
        if not lib_err <= 3e-2 * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"flash {name}: the library call differs "
                                 f"from the plain version by {lib_err}")
        del ref, diff, limit
        ms = cuda_ms(lambda: ops.flash_attention(q, k, v, win, causal))
        plain_ms = cuda_ms(lambda: attention_ref(q, k, v, win, causal))
        lib = {key: cuda_ms(fn) for key, fn in yardsticks.items()}
        pairs = visible_pairs(sq, sk, win, causal)
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        n_ops = 4 * hd * pairs * hq * b
        b_ms, b_by = bound(n_bytes, n_ops,
                           BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS)
        rows.append(dict(name=name, shape=(b, sq, sk, hq, hk, hd, win,
                                           causal, str(dt)),
                         err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=min(lib.values()), bound_ms=b_ms,
                         bound_by=b_by, pairs=pairs))
        causal_ms = (f", is_causal {lib['is_causal']:.6f} ms"
                     if "is_causal" in lib else "")
        log("kernels", f"flash_attention {name} B={b} Sq={sq} Sk={sk} "
            f"Hq={hq} Hk={hk} hd={hd} window={win} causal={causal} {dt}, "
            f"route {route}: {pairs} visible pairs per head, err {err:.3g} "
            f"(output RMS {rms:.4g}; {worst_ratio:.3f} of the limit; library "
            f"{lib_err:.3g}), kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, "
            f"library: boolean mask {lib['mask']:.6f} ms{causal_ms}; bound "
            f"{b_ms:.6f} ms ({b_by}), {n_ops / ms / 1e9:.1f} TFLOP/s")
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    return {"rows": rows, "worst": max(worst, flash_probes(dev))}


def flash_probes(dev) -> float:
    """The exact mask probes (``FLASH_PROBE_SHAPES`` x ``FLASH_PROBE_HDS``,
    in bf16 on the wgmma route and in fp32 on the scalar one) against the
    plain version.  Returns the largest error."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(31)
    worst = 0.0
    for b, sq, sk, hq, hk, win, causal in FLASH_PROBE_SHAPES:
        for hd in FLASH_PROBE_HDS:
            k = rng.standard_normal((b, sk, hk, hd), np.float32)
            v = rng.integers(-4, 5, (b, sk, hk, hd)).astype(np.float32)
            for dt, route in ((torch.bfloat16, "wgmma"),
                              (torch.float32, "scalar")):
                q_d = torch.zeros((b, sq, hq, hd), dtype=dt, device=dev)
                k_d, v_d = (torch.from_numpy(x).to(dev, dt) for x in (k, v))
                label = (f"flash probe B={b} Sq={sq} Sk={sk} Hq={hq} Hk={hk} "
                         f"hd={hd} window={win} causal={causal} {dt}")
                reset_launches()
                out = ops.flash_attention(q_d, k_d, v_d, win, causal)
                check_flash_route(label, route)
                ref = attention_ref(q_d, k_d, v_d, win, causal).float()
                torch.cuda.synchronize()
                diff = (out.float() - ref).abs()
                if dt == torch.bfloat16:
                    limit = FLASH_BF16_REL * ref.abs() + 1e-6
                else:
                    limit = FLASH_FP32_TOL * (1 + ref.abs())
                ratio = float((diff / limit).max())
                empty = int((ref.abs().amax(dim=(2, 3)) == 0).sum())
                log("kernels", f"{label}, route {route}: max abs err "
                    f"{float(diff.max()):.3g}, {ratio:.3f} of the limit; "
                    f"{empty} (batch row, position) pairs with every output "
                    f"0")
                if not (torch.isfinite(out).all() and ratio <= 1):
                    raise AssertionError(f"{label}: max abs err "
                                         f"{float(diff.max())}, {ratio:.3g} "
                                         f"of the limit")
                worst = max(worst, float(diff.max()))
    return worst


def scan_errors(name: str, y, y_ref, st, st_ref, fp32_tol: float) -> tuple:
    """Hold a scan kernel's (y, final state) against its plain version's:
    y at one bf16 unit (``FLASH_BF16_REL`` of |ref| plus the output's RMS,
    for the same reason as flash) when it is bf16, else at ``fp32_tol``
    (atol and rtol); the fp32 state at ``fp32_tol``.  Returns (max abs
    error over both, the worst share of its limit)."""
    bf16 = y.dtype == torch.bfloat16
    y, y_ref = y.float(), y_ref.float()
    dy, ds = (y - y_ref).abs(), (st - st_ref).abs()
    ratios = []
    for diff, ref, unit in ((dy, y_ref, bf16), (ds, st_ref, False)):
        if unit:
            rms = float(ref.pow(2).mean().sqrt())
            limit = FLASH_BF16_REL * (ref.abs() + rms)
        else:
            limit = fp32_tol * (1 + ref.abs())
        ratios.append(float((diff / limit).max()))
    finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    err = max(float(dy.max()), float(ds.max()))
    if not (finite and max(ratios) <= 1):
        raise AssertionError(f"{name}: max abs err {err} (y {ratios[0]:.3g}, "
                             f"state {ratios[1]:.3g} of the limit), finite "
                             f"{finite}")
    return err, max(ratios)


def scan_layout_text(info, blocks: int) -> str:
    """A scan kernel's resources as the card reports them, its grid and the
    waves that grid takes (every SM holding as many blocks as fit)."""
    waves = blocks / (info.n_sm * max(info.blocks_per_sm, 1))
    return (f"{info.registers} registers a thread, {info.local_bytes} "
            f"bytes spilled, {info.static_smem + info.dynamic_smem} bytes "
            f"of shared memory a block, {info.threads} threads, "
            f"{info.blocks_per_sm} resident blocks per SM of {info.n_sm} "
            f"SMs, grid {blocks} ({waves:.3f} waves)")


def wkv_phase(dev) -> dict:
    from repro_torch.kernels.rwkv6 import kernel, ops
    from repro_torch.kernels.rwkv6.ref import wkv_ref

    rng = np.random.default_rng(23)
    kd, rows, worst = 64, [], 0.0
    for name, b, s, h, dt, init, dead in WKV_CASES:
        shape = (b, s, h, kd)
        r, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32)
                                    * 0.5).to(dev, dt) for _ in range(3))
        # the model's log decay, -exp(base + lora) with base in [-8, -4)
        # (the init rule) and a spread of LoRA terms; a few entries far
        # below exp's range, whose decay must underflow to 0, not NaN
        logw = -np.exp(rng.uniform(-8.0, -4.0, shape)
                       + rng.standard_normal(shape))
        logw[:, :4, 0, :8] = -1e30
        for toks, chans in dead:
            logw[:, toks, 0, chans] = -1e30
        logw = torch.from_numpy(logw.astype(np.float32)).to(dev)
        u = torch.from_numpy(rng.standard_normal((h, kd), np.float32)
                             * 0.5).to(dev)
        s0 = (torch.zeros((b, h, kd, kd), device=dev) if init == "zeros"
              else torch.from_numpy(rng.standard_normal((b, h, kd, kd),
                                                        np.float32)
                                    * 0.1).to(dev))
        y, st = ops.wkv(r, k, v, logw, u, s0)
        y_ref, st_ref = wkv_ref(r, k, v, logw, u, s0)
        torch.cuda.synchronize()
        label = f"wkv {name} {'bf16' if dt == torch.bfloat16 else 'fp32'}"
        err, ratio = scan_errors(label, y, y_ref, st, st_ref, WKV_FP32_TOL)
        worst = max(worst, err)
        ms = cuda_ms(lambda: ops.wkv(r, k, v, logw, u, s0))
        dev_ms = (device_ms(lambda: ops.wkv(r, k, v, logw, u, s0),
                            "wkv_kernel") if s >= 2048 else None)
        plain_ms = cuda_ms(lambda: wkv_ref(r, k, v, logw, u, s0))
        # bytes: r, k, v, logw, u and s0 read once, y and the state
        # written once.  Operations of the chunked form (chunks of L = 64)
        # per token and head, on the bf16 tensor cores: the attention
        # within the chunk and its product with v (L K each, the lower
        # half), r S and the state update (2 K^2 each).  Beside it, the
        # per-token form's fp32 operations (r S 2 K^2, the decay-and-add
        # update 3 K^2, the bonus 5 K, exp(logw) K), the bound the
        # per-token kernel was held to
        n_bytes = ((3 + 1) * r.numel() * r.element_size() + logw.numel() * 4
                   + u.numel() * 4 + 2 * s0.numel() * 4)
        n_ops = b * s * h * (2 * kernel.CHUNK * kd + 4 * kd * kd)
        b_ms, b_by = bound(n_bytes, n_ops, BF16_FLOPS)
        tok_ms, _ = bound(0, b * s * h * (5 * kd * kd + 6 * kd))
        rows.append(dict(name=name, shape=(b, s, h, kd, str(dt)), err=err,
                         ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, token_ops_ms=tok_ms))
        lay = kernel.layout(b, h, r.element_size())
        info = kernel.info(r.device.index, kernel.DTYPE_CODES[dt])
        log("kernels", f"rwkv6 {label} B={b} S={s} H={h} K={kd} s0={init}"
            f"{' -1e30 mid-sequence' if dead else ''}: err {err:.3g} "
            f"({ratio:.3f} of the limit), kernel {ms:.6f} ms (device "
            f"{ms_text(dev_ms)}), plain {plain_ms:.6f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}; {n_bytes / 1e6:.1f} MB, {b_ms / ms:.3f} "
            f"of it), the per-token form's fp32 operations {tok_ms:.6f} ms; "
            f"{n_bytes / ms / 1e6:.1f} GB/s; "
            f"{scan_layout_text(info, lay.blocks)}")
        del r, k, v, logw, y, y_ref
        torch.cuda.empty_cache()
    return {"rows": rows, "worst": worst}


def ssd_phase(dev) -> dict:
    from repro_torch.kernels.mamba2 import kernel, ops
    from repro_torch.kernels.mamba2.ref import ssd_ref

    rng = np.random.default_rng(29)
    p, rows, worst = 64, [], 0.0
    for name, b, s, h, n, dt, init in SSD_CASES:
        x = torch.from_numpy(rng.standard_normal((b, s, h, p), np.float32)
                             * 0.5).to(dev, dt)
        B, C = (torch.from_numpy(rng.standard_normal((b, s, n), np.float32)
                                 * 0.5).to(dev, dt) for _ in range(2))
        # softplus'd steps and A = -exp(a_log), a_log = log U[1, 16) (the
        # init rule)
        dts = torch.nn.functional.softplus(torch.from_numpy(
            rng.standard_normal((b, s, h), np.float32)).to(dev))
        A = -torch.from_numpy(rng.uniform(1.0, 16.0, h)
                              .astype(np.float32)).to(dev)
        h0 = (None if init is None
              else torch.from_numpy(rng.standard_normal((b, h, p, n),
                                                        np.float32)
                                    * 0.1).to(dev))
        y, st = ops.ssd(x, dts, B, C, A, h0)
        y_ref, st_ref = ssd_ref(x, dts, B, C, A, h0)
        torch.cuda.synchronize()
        label = f"ssd {name} {'bf16' if dt == torch.bfloat16 else 'fp32'}"
        err, ratio = scan_errors(label, y, y_ref, st, st_ref, SSD_FP32_TOL)
        worst = max(worst, err)
        ms = cuda_ms(lambda: ops.ssd(x, dts, B, C, A, h0))
        dev_ms = (device_ms(lambda: ops.ssd(x, dts, B, C, A, h0),
                            "ssd_kernel") if s >= 4096 else None)
        plain_ms = cuda_ms(lambda: ssd_ref(x, dts, B, C, A, h0))
        # bytes: x, dt, B, C, A and h0 read once, y and the state written
        # once.  Operations of the chunked form (chunks of L = 64) per
        # token and head, on the bf16 tensor cores: M x (L P, the lower
        # half), C B^T (L P, its share of a head), C H^T and the state
        # update (2 N P each).  Beside it, the per-token form's fp32
        # operations (exp(dt A) 2, dt x P, the decay-and-add update 3 P N,
        # C.h 2 P N), the bound the per-token kernel was held to
        n_bytes = (2 * x.numel() * x.element_size() + dts.numel() * 4
                   + 2 * B.numel() * B.element_size() + A.numel() * 4
                   + (1 if h0 is None else 2) * b * h * p * n * 4)
        n_ops = b * s * h * (2 * kernel.CHUNK * p + 4 * n * p)
        b_ms, b_by = bound(n_bytes, n_ops, BF16_FLOPS)
        tok_ms, _ = bound(0, b * s * h * (5 * p * n + p + 2))
        rows.append(dict(name=name, shape=(b, s, h, p, n, str(dt)), err=err,
                         ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, token_ops_ms=tok_ms))
        lay = kernel.layout(b, h, n, x.element_size())
        info = kernel.info(x.device.index, kernel.DTYPE_CODES[dt], n,
                           lay.cols)
        log("kernels", f"mamba2 {label} B={b} S={s} H={h} P={p} N={n} "
            f"h0={init}: err {err:.3g} ({ratio:.3f} of the limit), kernel "
            f"{ms:.6f} ms (device {ms_text(dev_ms)}), plain {plain_ms:.6f} "
            f"ms, bound {b_ms:.6f} ms ({b_by}; {n_bytes / 1e6:.1f} MB, "
            f"{b_ms / ms:.3f} of it), the per-token form's fp32 operations "
            f"{tok_ms:.6f} ms; {n_bytes / ms / 1e6:.1f} GB/s; {lay.cols} "
            f"columns a block; {scan_layout_text(info, lay.blocks)}")
        del x, B, C, dts, y, y_ref
        torch.cuda.empty_cache()
    return {"rows": rows, "worst": worst}


def scan_sass() -> None:
    """Whether the scan kernels' compiled code holds tensor-core
    instructions (HMMA for mma.sync, HGMMA for wgmma), from cuobjdump -sass
    of the built library; a note where the toolkit's cuobjdump cannot read
    it."""
    from repro_torch.kernels import build

    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    try:
        out = subprocess.run([str(tool), "-sass", str(build.build())],
                             capture_output=True, text=True, timeout=300,
                             check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log("kernels", f"sass of the scan kernels could not be read ({e})")
        return
    counts = {}
    fn = None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            fn = next((k for k in ("ssd_kernel", "wkv_kernel") if k in name),
                      None)
            if fn:
                counts.setdefault(fn, [0, 0, 0])[0] += 1
        elif fn and "HGMMA" in line:
            counts[fn][2] += 1
        elif fn and "HMMA" in line:
            counts[fn][1] += 1
    text = "; ".join(f"{k}: {v[0]} variants, {v[1]} HMMA and {v[2]} HGMMA "
                     f"instructions" for k, v in sorted(counts.items()))
    log("kernels", f"sass of the scan kernels: {text or 'none found'}")
    if any(v[1] + v[2] == 0 for v in counts.values()) or len(counts) < 2:
        raise AssertionError("a scan kernel's code holds no tensor-core "
                             "instruction")


def decode_phase(dev) -> dict:
    from repro_torch.kernels.decode_attention import kernel, ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref

    rng = np.random.default_rng(37)
    rows, worst = [], 0.0
    for name, b, s, hq, hk, hd, clen, win, dt in DECODE_CASES:
        q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(dev, dt) for shape in ((b, 1, hq, hd), (b, s, hk, hd),
                                              (b, s, hk, hd)))
        # the lengths live on the device, as in lockstep decode
        cl = torch.full((), clen, dtype=torch.int32, device=dev)
        w = torch.full((), win, dtype=torch.int32, device=dev)
        out = ops.decode_attention(q, k, v, w, cl)
        ref = decode_attention_ref(q, k, v, w, cl).float()
        torch.cuda.synchronize()
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        rms = float(ref.pow(2).mean().sqrt())
        if dt == torch.bfloat16:
            limit, what = FLASH_BF16_REL * (ref.abs() + rms), \
                f"{FLASH_BF16_REL} of |ref| + RMS {rms:.4g}"
        else:
            limit, what = DECODE_FP32_TOL * (1 + ref.abs()), \
                f"{DECODE_FP32_TOL} (atol and rtol)"
        ratio = float((diff / limit).max())
        if not (torch.isfinite(out).all() and ratio <= 1):
            raise AssertionError(f"decode_attention {name}: max abs err "
                                 f"{err}, {ratio:.3g} of the limit {what}")
        worst = max(worst, err)
        # PyTorch's own attention call on the same inputs and mask, as the
        # yardstick: (B, H, S, hd) layout, GQA by enable_gqa
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        pos = torch.arange(s, device=dev)
        visible = ((pos < clen) & (pos >= clen - win))[None]     # (L=1, S)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=visible, enable_gqa=True)

        lib_err = float((library().transpose(1, 2).float() - ref).abs().max())
        if not lib_err <= 3e-2 * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"decode_attention {name}: the library call "
                                 f"differs from the plain version by "
                                 f"{lib_err}")
        del ref, diff, limit
        ms = cuda_ms(lambda: ops.decode_attention(q, k, v, w, cl))
        dev_ms = device_ms(lambda: ops.decode_attention(q, k, v, w, cl),
                           "decode_attention_kernel")
        plain_ms = cuda_ms(lambda: decode_attention_ref(q, k, v, w, cl))
        library_ms = cuda_ms(library)
        # what this data needs: q read and the output written once, and of
        # the caches only the visible positions, k and v, each read once;
        # a multiply-add per (head, visible position, element) for q.k and
        # again for p.v
        n_vis = max(0, min(clen, s) - max(clen - win, 0))
        n_bytes = (2 * q.numel() + 2 * b * n_vis * hk * hd) * q.element_size()
        n_ops = 4 * hd * n_vis * hq * b
        b_ms, b_by = bound(n_bytes, n_ops,
                           BF16_FLOPS if dt == torch.bfloat16 else FP32_FLOPS)
        rows.append(dict(name=name, shape=(b, s, hq, hk, hd, clen, win,
                                           str(dt)),
                         err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=b_ms, bound_by=b_by))
        occ, lay = kernel.plan(q, k)
        # a wave: every SM holding as many blocks as the layout lets it
        per_sm = min(occ.blocks_per_sm, kernel.MAX_BLOCKS_PER_SM)
        waves = lay.blocks / (occ.n_sm * per_sm)
        log("kernels", f"decode_attention {name} B={b} S={s} Hq={hq} Hk={hk} "
            f"hd={hd} cache_len={clen} window={win} {dt}: {n_vis} visible "
            f"positions, err {err:.3g} (output RMS {rms:.4g}; {ratio:.3f} of "
            f"the limit; library "
            f"{lib_err:.3g}), kernel {ms:.6f} ms (device {ms_text(dev_ms)}), "
            f"plain {plain_ms:.6f} ms, library {library_ms:.6f} ms, bound "
            f"{b_ms:.6f} ms ({b_by}), {n_bytes / ms / 1e6:.1f} GB/s; "
            f"{occ.registers} registers a thread, {occ.blocks_per_sm} "
            f"resident blocks per SM ({per_sm} used) of {occ.n_sm} SMs, grid "
            f"{lay.blocks} ({waves:.3f} waves of {per_sm} an SM), "
            f"{lay.n_split} splits of {lay.tiles} {lay.tile}-position tiles")
        del q, k, v, qt, kt, vt, out
        torch.cuda.empty_cache()
    return {"rows": rows, "worst": worst}


# ---------------------------------------------------------------------------
# 4. device vs host routing
# ---------------------------------------------------------------------------


def _outcome(uid: int, arm: int) -> tuple:
    return 0.2 + 0.25 * ((uid + arm) % 3), 0.01 * (arm + 1) + 0.001 * (uid % 5)


def router_phase(dev) -> None:
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.router import GreenServRouter
    from repro_torch.core.types import Feedback, ModelProfile, RouterConfig
    from repro_torch.data.stream import labeled_sample, make_stream

    routers = {}
    for featurize in ("device", "host"):
        pool = ModelPool([ModelProfile(name=a, family=ARCH_PROFILES[a][0],
                                       params_b=ARCH_PROFILES[a][1])
                          for a in SERVE_ARCHS])
        routers[featurize] = GreenServRouter(
            RouterConfig(lam=0.4, energy_scale_wh=0.05, featurize=featurize),
            pool, device=dev)
    texts, labels = labeled_sample(n_per_task=20, seed=1)
    acc = routers["device"].context.task_classifier.fit(texts, labels)
    routers["host"].context.task_classifier.load_state_dict(
        routers["device"].context.task_classifier.state_dict())
    stream = make_stream(per_task=13, seed=7)[:64]
    seen = {}
    for name, r in routers.items():
        rows, wall = [], 0.0
        for i in range(0, 64, 16):
            qs = stream[i:i + 16]
            t = time.perf_counter()
            ds = r.route_batch(qs)        # ends in a device→host transfer
            wall += time.perf_counter() - t
            rows += [(d.model_index, d.context.task_label, d.context.cluster,
                      d.context.complexity_bin) for d in ds]
            r.feedback_batch([Feedback(
                query_uid=q.uid, model_index=d.model_index,
                accuracy=_outcome(q.uid, d.model_index)[0],
                energy_wh=_outcome(q.uid, d.model_index)[1], latency_ms=1.0)
                for q, d in zip(qs, ds)])
        seen[name] = rows
        log("router", f"featurize={name}: route_batch {wall / 64 * 1e3:.4f} "
            f"ms/query wall (batches of 16), decision clock "
            f"{r.mean_decision_ms:.4f} ms/query, arms "
            f"{np.bincount([x[0] for x in rows], minlength=len(SERVE_ARCHS))}")
    if seen["device"] != seen["host"]:
        bad = [i for i, (a, b) in enumerate(zip(seen["device"], seen["host"]))
               if a != b]
        raise AssertionError(f"device and host routing differ at {bad[:8]}")
    log("router", f"64 queries: arms, labels, clusters, bins identical on "
        f"both featurize paths (classifier train acc {acc:.3f})")


# ---------------------------------------------------------------------------
# 5. serving through PoolServer on four full-width engines
# ---------------------------------------------------------------------------


def exact_match_accuracy(query, resp) -> float:
    """EM against the stream's reference (random weights rarely match —
    the router learns their low quality online)."""
    if not query.reference:
        return 0.0
    return float(query.reference.strip().lower() in resp.text.strip().lower())


def decode_only(server) -> bool:
    """Nothing waits for a slot, every occupied slot is past its prompt,
    and at least two slots decode: the next steps run decode ticks only."""
    engines = server.engines.values()
    live = [r for e in engines for r in e.slots
            if r is not None and not r.defunct]
    return (not server.arrivals and not any(e.queue for e in engines)
            and len(live) >= 2 and all(r.prefill_done for r in live))


def serving_phase(dev) -> dict:
    from repro_torch.configs import for_mode, get_config
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.router import GreenServRouter
    from repro_torch.core.types import RouterConfig
    from repro_torch.data import stream as stream_lib
    from repro_torch.data import tokenizer as tok
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import PoolServer

    t0 = time.perf_counter()
    engines = {}
    for i, arch in enumerate(SERVE_ARCHS):
        cfg = for_mode(get_config(arch, vocab_size=tok.VOCAB_SIZE,
                                  max_seq_len=SERVE_MAX_LEN, use_pallas=True),
                       "serve")
        eng = engines[arch] = ModelEngine(
            arch, cfg, seed=i, max_batch=4, max_len=SERVE_MAX_LEN,
            detokenize=tok.decode, prefill_chunk=SERVE_CHUNK, device=dev)
        moe = (f", {cfg.n_experts} experts top-{cfg.top_k} of width "
               f"{cfg.moe_d_ff} + {cfg.n_shared_experts} shared"
               if cfg.layout == "moe" else "")
        n_params = sum(p.numel() for p in eng.params.parameters())
        log("serve", f"{arch}: {cfg.n_layers}/{cfg.n_layers} layers (no "
            f"depth cut), d_model {cfg.d_model}, d_ff {cfg.d_ff}{moe}, "
            f"{n_params / 1e9:.3f} B params in bf16 "
            f"({cfg.active_param_count() / 1e9:.2f} B active by the energy "
            f"model), prefill chunk {eng.prefill_chunk}")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    router = GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05),
                             ModelPool([e.profile for e in engines.values()]),
                             device=dev)
    server = PoolServer(router, engines, tokenizer=tok.encode,
                        accuracy_fn=exact_match_accuracy,
                        prefill_chunk=SERVE_CHUNK)
    queries = stream_lib.make_stream(per_task=12, seed=0)
    # At max_len 192 most stream prompts are >= 191 byte tokens and stop at
    # their first token.  A decode slice follows them: each prompt is its
    # task's instruction line alone, which leaves room for the task's whole
    # max_new_tokens (96 for math, 128 for summaries), so the decode ticks
    # at full width do real work.
    decode_slice = [dataclasses.replace(q, uid=q.uid + 10_000,
                                        text=q.text.split("\n", 1)[0])
                    for q in stream_lib.make_stream(per_task=4, seed=5)]
    arrivals = queries + decode_slice
    torch.cuda.reset_peak_memory_stats(dev)
    # the profiler's first session pays its own start-up: pay it here,
    # outside the main path
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(8, device=dev).add_(1)
        torch.cuda.synchronize()
    # the main path: counts start at 0 here and are read right after.
    # Arrivals are enqueued one per step, as the launcher does; three
    # windows of the same run are profiled (after 20 steps, after 200, and
    # at the first step with decode ticks only), then the server drains.
    reset_launches()
    pending, step_s, windows = list(arrivals), [], []
    triggers = (("prefill", lambda: len(step_s) >= 20),
                ("backlog", lambda: len(step_s) >= 200),
                ("decode", lambda: not pending and decode_only(server)))
    t1 = time.perf_counter()
    while pending or (len(windows) < len(triggers)
                      and (server.inflight or server.arrivals)):
        if len(windows) < len(triggers) and triggers[len(windows)][1]():
            windows.append(profile_window(server, pending,
                                          triggers[len(windows)][0],
                                          step_s[-PROFILE_STEPS:]))
            continue
        if pending:
            server.enqueue(pending.pop(0))
        t = time.perf_counter()
        server.step()
        step_s.append(time.perf_counter() - t)
    server.run_until_drained()

    def direct_slice(name: str, uid_offset: int) -> list:
        """A slice of the decode prompts straight into one engine; every
        request must be answered."""
        eng = engines[name]
        reqs = [Request(query=dataclasses.replace(q, uid=q.uid + uid_offset),
                        prompt_tokens=tok.encode(q.text),
                        max_new_tokens=q.max_new_tokens)
                for q in decode_slice[:eng.max_batch]]
        eng.submit_many(reqs)
        done = []
        while eng.pending:
            done += eng.step()
        if len(done) != len(reqs):
            raise AssertionError(f"{name} direct slice: {len(done)}/"
                                 f"{len(reqs)} answered")
        return done

    # every engine must serve a few queries at full width, and the MoE
    # engine must run decode-only ticks: where the router sent one too
    # few, a slice goes straight into it
    moe_eng, direct = engines[MOE_ARCH], {}
    for i, name in enumerate(SERVE_ARCHS):
        if (server.dispatch_counts.get(name, 0) < MIN_ROUTED
                or (name == MOE_ARCH and moe_eng.tick_counts["decode"]
                    < MOE_MIN_DECODE_TICKS)):
            direct[name] = direct_slice(name, 10_000 * (i + 1))
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t1
    launches = read_launches()
    if len(server.responses) != len(arrivals):
        raise AssertionError(f"{len(server.responses)}/{len(arrivals)} "
                             f"queries answered")
    moe_ticks = sum(moe_eng.tick_counts.values())
    if not (moe_eng.tick_counts["chunk"] and moe_eng.tick_counts["decode"]):
        raise AssertionError(f"the MoE engine ran {moe_eng.tick_counts}: "
                             f"it needs chunk and decode ticks")
    if launches["moe_gating"] != moe_eng.cfg.n_layers * moe_ticks:
        raise AssertionError(f"moe_gating launched {launches['moe_gating']} "
                             f"times over {moe_ticks} MoE ticks of "
                             f"{moe_eng.cfg.n_layers} layers")
    for name, eng in engines.items():
        if eng.nonfinite_ticks:
            raise AssertionError(f"{name}: {eng.nonfinite_ticks} ticks with "
                                 f"non-finite logits")
    for name in ("featurize", "linucb", "moe_gating"):
        if launches[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")
    # token-wise serving runs the one-step recurrences, never the scans
    if launches["rwkv6"] or launches["mamba2"]:
        raise AssertionError(f"serving launched a prefill scan: {launches}")
    if engines[RWKV_ARCH].prefill_chunk != 1 or engines[
            RWKV_ARCH].tick_counts["chunk"]:
        raise AssertionError(f"{RWKV_ARCH} was not served token-wise")
    resp = list(server.responses.values())
    decoded = sum(sum(e.decode_tokens.values()) for e in engines.values())
    if decoded < 200:
        raise AssertionError(f"only {decoded} tokens decoded: the decode "
                             f"path at full width did no real work")
    per_q = router.context.mean_overhead_ms()
    steps = server._step_idx
    log("serve", f"{len(resp)}/{len(arrivals)} queries answered "
        f"({len(queries)} stream + {len(decode_slice)} decode slice) in "
        f"{t_serve:.3f} s, {steps} scheduler steps, "
        f"{t_serve / steps * 1e3:.3f} ms per step (engine init "
        f"{t_init:.3f} s); arms "
        f"{dict(zip(router.pool.names, map(int, router.selection_counts())))}; "
        f"{sum(r.output_tokens <= 1 for r in resp)} queries stopped at "
        f"their first token; then straight into engines: "
        f"{ {k: len(v) for k, v in direct.items()} }")
    for name, e in engines.items():
        n_c, n_d = e.tick_counts["chunk"], e.tick_counts["decode"]
        s_c, s_d = e.tick_seconds["chunk"], e.tick_seconds["decode"]
        prompt = sum(r.input_tokens for r in resp + direct.get(name, [])
                     if r.model_name == name)
        if e.prefill_chunk == 1:
            # token-wise: every prompt token is fed by a decode tick
            log("serve", f"{name}: {n_d} decode ticks (token-wise prompts), "
                f"{s_d / max(n_d, 1) * 1e3:.3f} ms each, "
                f"{prompt / max(n_d, 1):.3f} prompt tokens and "
                f"{e.decode_tokens['decode'] / max(n_d, 1):.3f} decode "
                f"tokens per tick ({prompt} and "
                f"{e.decode_tokens['decode']} in all; "
                f"{(prompt + e.decode_tokens['decode']) / max(s_d, 1e-9):.1f}"
                f" tok/s of tick time)")
            continue
        log("serve", f"{name}: {n_c} chunk ticks, "
            f"{s_c / max(n_c, 1) * 1e3:.3f} ms each, {prompt} prompt tokens "
            f"({prompt / max(s_c, 1e-9):.1f} tok/s of chunk-tick time) and "
            f"{e.decode_tokens['chunk']} decode riders; {n_d} decode ticks, "
            f"{s_d / max(n_d, 1) * 1e3:.3f} ms each, "
            f"{e.decode_tokens['decode'] / max(n_d, 1):.3f} tokens per "
            f"decode tick ({e.decode_tokens['decode'] / max(s_d, 1e-9):.1f} "
            f"tok/s of decode-tick time)")
    log("serve", f"routing: decision {router.mean_decision_ms:.4f} ms/query, "
        f"host hashing {per_q['featurize']:.4f} ms/query, Flesch counts "
        f"{per_q['complexity']:.4f} ms/query; launches {launches} "
        f"({moe_eng.cfg.n_layers} gating launches per MoE tick x "
        f"{moe_ticks} ticks)")
    weights = sum(p.numel() * p.element_size() for e in engines.values()
                  for p in e.params.parameters())
    log("serve", f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)}"
        f" bytes, of which the four engines' weights {weights} bytes; "
        f"modeled energy {sum(r.energy_wh for r in resp):.6f} Wh")
    for key, what in (("busy", "kernels over the window's own wall time"),
                      ("busy_before", "kernels over the unprofiled steps "
                       "just before")):
        busy = [w[key] for w in windows]
        each = ", ".join(f"{w['label']} {w[key]:.4f}" for w in windows)
        log("profile", f"card busy share, {what}: {each} (min "
            f"{min(busy):.4f}, max {max(busy):.4f})")
    return launches, engines


def profile_window(server, pending, label: str, before_s) -> dict:
    """Where a serving step's time goes, in one window of the main run:
    ``PROFILE_STEPS`` scheduler steps (still enqueueing one arrival each)
    under torch.profiler with device activity.  The card's busy share
    is the kernels' summed device time over the same steps' wall time; the
    profiler lengthens the host side, so the unprofiled steps just before
    (``before_s``) are printed beside it for scale."""
    from torch.profiler import ProfilerActivity, profile

    ticks0 = {n: dict(e.tick_counts) for n, e in server.engines.items()}
    # device activity only: recording every host op would lengthen the
    # steps being measured
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            if pending:
                server.enqueue(pending.pop(0))
            server.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / PROFILE_STEPS
    dev_ms, top = kernel_times(prof, PROFILE_STEPS, f"{label} window")
    before_ms = sum(before_s) / len(before_s) * 1e3
    ticks = {n: {k: v - ticks0[n][k] for k, v in e.tick_counts.items()}
             for n, e in server.engines.items()}
    log("profile", f"{label} window (steps {server._step_idx - PROFILE_STEPS + 1}"
        f"-{server._step_idx}): {dev_ms:.3f} ms of kernels per step over "
        f"{wall_ms:.3f} ms wall per step → card busy {dev_ms / wall_ms:.4f}; "
        f"the {len(before_s)} unprofiled steps before took {before_ms:.3f} "
        f"ms each ({dev_ms / before_ms:.4f}); engine ticks in the window "
        f"{ticks}")
    for line in top:
        log("profile", line)
    return {"label": label, "dev_ms": dev_ms, "wall_ms": wall_ms,
            "busy": dev_ms / wall_ms, "busy_before": dev_ms / before_ms}


# ---------------------------------------------------------------------------
# 6. one-shot prefill at full width through the flash, gating and WKV
#    kernels
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded_gates():
    """Record the expert indices of every gate call — through the gating
    kernel's wrapper or the plain ``moe.top_k_gating`` — in call order."""
    from repro_torch.kernels.moe_gating import ops as gating_ops
    from repro_torch.models import moe

    seen, real = [], (gating_ops.topk_gating, moe.top_k_gating)

    def recording(fn):
        def gate(logits, k):
            w, i = fn(logits, k)
            seen.append(i)
            return w, i
        return gate

    gating_ops.topk_gating, moe.top_k_gating = map(recording, real)
    try:
        yield seen
    finally:
        gating_ops.topk_gating, moe.top_k_gating = real


def logit_gap(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |diff| over the range of ``want``, mean |diff| over its mean
    |logit|), in fp32."""
    got, want = got.float(), want.float()
    return (float((got - want).abs().max() / want.abs().max()),
            float((got - want).abs().mean() / want.abs().mean()))


def kernel_times(prof, n: int, what: str) -> tuple:
    """From a torch.profiler session with device activity over ``n``
    steps: (kernel ms per step on the card, log lines of the six longest
    kernels); raises where the profiler saw no kernel time."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if dev_ms <= 0:
        raise AssertionError(f"{what}: the profiler recorded no kernel time "
                             f"on the card")
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    return dev_ms, [f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/step  "
                    f"{e.count / n:7.1f} calls/step  {e.key[:70]}"
                    for e in top]


def layers_view(model, cfg, indices, **changes) -> tuple:
    """(a view of ``model`` holding only its layers at ``indices``, weights
    shared, and ``cfg`` cut to them, with ``changes``)."""
    view = copy.copy(model)
    view._modules = dict(model._modules)
    view.layers = torch.nn.ModuleList(model.layers[i] for i in indices)
    return view, dataclasses.replace(cfg, n_layers=len(view.layers),
                                     **changes)


def upcast(dev, model, cfg) -> tuple:
    """(an fp32 ``DecoderLM`` holding ``model``'s weights upcast, and
    ``cfg`` in fp32)."""
    from repro_torch.models import lm

    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    m32 = lm.DecoderLM(cfg32, dev)
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), model.parameters()):
            p32.copy_(p16.float())
    return m32, cfg32


def one_shot_and_chunked(dev, model, cfg, tokens, chunk: int) -> tuple:
    """(``api.prefill``'s last-position logits, the chunked prefill's:
    ``api.prefill_chunk`` over slabs of ``chunk`` into a fresh cache)."""
    from repro_torch.models import api

    one = api.prefill(model, {"tokens": tokens}, cfg)
    b, s = tokens.shape
    cache = api.init_cache(cfg, b, s, dev)
    n_act = torch.full((b,), chunk, dtype=torch.int32, device=dev)
    for start in range(0, s, chunk):
        out, cache = api.prefill_chunk(
            model, tokens[:, start:start + chunk], cache, cfg, n_act)
    return one, out[:, -1]


def moe_prefill_check(dev, model, cfg, batch) -> None:
    """qwen2-moe's one-shot prefill at its first ``PREFILL_CHECK_DEPTH``
    layers against (a) its chunked prefill at S = 512, in bf16 and, on the
    same weights upcast, in fp32, and (b) its ``use_pallas=False`` path
    (plain gating and ``flash_prefill``) on the phase's batch, in bf16;
    then (b) again at full depth, printed, with the expert choices that
    differ between the two paths (not checked: see PREFILL_REL_TOL)."""
    from repro_torch.models import api

    s, chunk, n = 512, 64, PREFILL_CHECK_DEPTH
    # capacity E/k so that no group drops a token: capacity is per dispatch
    # group (the one-shot row is one group of 512, a chunk one of 64), and
    # a token dropped by one path and kept by the other is a different
    # computation, not rounding
    nodrop = dataclasses.replace(cfg,
                                 capacity_factor=cfg.n_experts / cfg.top_k)
    toks = batch["tokens"][:1, :s]
    view, cut = layers_view(model, nodrop, range(n))
    one, chunked = one_shot_and_chunked(dev, view, cut, toks, chunk)
    gap_c = logit_gap(chunked, one)
    m32, cut32 = upcast(dev, view, cut)
    reset_launches()
    one, chunked = one_shot_and_chunked(dev, m32, cut32, toks, chunk)
    check_flash_route(f"{MOE_ARCH} fp32, first {n} layers", "scalar")
    gap_32 = logit_gap(chunked, one)
    del m32, one, chunked
    torch.cuda.empty_cache()
    gaps_p = {}
    for depth in (n, cfg.n_layers):
        view, cut = layers_view(model, cfg, range(depth))
        with recorded_gates() as kernel_idx:
            fast = api.prefill(view, batch, cut)
        with recorded_gates() as plain_idx:
            plain = api.prefill(view, batch, dataclasses.replace(
                cut, use_pallas=False))
        differ = sum(int((torch.sort(a, dim=-1).values
                          != torch.sort(b, dim=-1).values).sum())
                     for a, b in zip(kernel_idx, plain_idx))
        total = sum(a.numel() for a in kernel_idx)
        gaps_p[depth] = logit_gap(plain, fast)
        log("prefill", f"{MOE_ARCH}, first {depth} layers, bf16: use_pallas "
            f"True vs False (B={batch['tokens'].shape[0]} "
            f"S={batch['tokens'].shape[1]}) max |diff| "
            f"{gaps_p[depth][0]:.5f} of the logit range, mean "
            f"{gaps_p[depth][1]:.5f} of the mean |logit|; {differ} of "
            f"{total} expert choices differ")
    log("prefill", f"{MOE_ARCH}, first {n} layers: one-shot vs chunked "
        f"(S={s}, chunks of {chunk}) max |diff| {gap_c[0]:.5f} of the logit "
        f"range in bf16 (mean {gap_c[1]:.5f} of the mean |logit|), "
        f"{gap_32[0]:.7f} in fp32 (mean {gap_32[1]:.7f})")
    for what, rel, tol in (
            ("one-shot vs chunked, bf16", gap_c[0], PREFILL_REL_TOL),
            ("one-shot vs chunked, fp32", gap_32[0], PREFILL_FP32_REL_TOL),
            ("use_pallas True vs False, bf16", gaps_p[n][0], PREFILL_REL_TOL)):
        if not rel <= tol:
            raise AssertionError(f"{MOE_ARCH}, {n} layers: {what} {rel:.7f} "
                                 f"of the logit range > {tol}")
    log("prefill", f"{MOE_ARCH}, first {n} layers: bf16 gaps within "
        f"{PREFILL_REL_TOL}, fp32 within {PREFILL_FP32_REL_TOL} of the logit "
        f"range (checked)")


def one_shot_and_token_wise(dev, model, cfg, tokens) -> tuple:
    """(``api.prefill``'s last-position logits, the last logits of feeding
    the same tokens one at a time through ``api.serve_step`` from a fresh
    cache)."""
    from repro_torch.models import api

    one = api.prefill(model, {"tokens": tokens}, cfg)
    b, s = tokens.shape
    cache = api.init_cache(cfg, b, s, dev)
    for t in range(s):
        out, cache = api.serve_step(model, tokens[:, t:t + 1], cache, cfg)
    return one, out[:, 0]


def recurrent_prefill_check(dev, arch, model, cfg, batch) -> None:
    """A recurrent model's one-shot prefill (through the scan kernel) at its
    first ``PREFILL_CHECK_DEPTH`` layers against (a) its token-wise
    ``serve_step`` (the serving path, one-step recurrences) over the first
    ``TOKENWISE_S`` tokens, in bf16 and, on the same weights upcast, in
    fp32, and (b) its ``use_pallas=False`` path (the chunked scans, and
    ``flash_prefill`` at the hybrid's sites) on the phase's batch, in
    bf16 — checked.  The same at the hybrid's first attention site and at
    full depth ((a) over ``TOKENWISE_FULL_S`` tokens, bf16) is printed,
    not checked (see PREFILL_REL_TOL)."""
    from repro_torch.models import api

    n = PREFILL_CHECK_DEPTH
    depths = [n] + ([cfg.attn_every] if cfg.layout == "mamba_hybrid"
                    else []) + [cfg.n_layers]
    gaps = {}
    for depth in dict.fromkeys(depths):
        full = depth == cfg.n_layers and depth > n
        s_tw = TOKENWISE_FULL_S if full else TOKENWISE_S
        toks = batch["tokens"][:, :s_tw]
        view, cut = layers_view(model, cfg, range(depth))
        one, tw = one_shot_and_token_wise(dev, view, cut, toks)
        row = {"bf16": logit_gap(tw, one)}
        if not full:
            m32, cut32 = upcast(dev, view, cut)
            reset_launches()
            one, tw = one_shot_and_token_wise(dev, m32, cut32, toks)
            check_flash_route(f"{arch} fp32, first {depth} layers", "scalar")
            row["fp32"] = logit_gap(tw, one)
            del m32
        fast = api.prefill(view, batch, cut)
        plain = api.prefill(view, batch,
                            dataclasses.replace(cut, use_pallas=False))
        row["pallas"] = logit_gap(plain, fast)
        del one, tw, fast, plain
        torch.cuda.empty_cache()
        gaps[depth] = row
        fp32 = (f", {row['fp32'][0]:.7f} in fp32 (mean {row['fp32'][1]:.7f})"
                if "fp32" in row else "")
        log("prefill", f"{arch}, first {depth} layers: one-shot vs token-wise "
            f"(B={toks.shape[0]} S={s_tw}) max |diff| {row['bf16'][0]:.5f} "
            f"of the logit range in bf16 (mean {row['bf16'][1]:.5f} of the "
            f"mean |logit|){fp32}; use_pallas True vs False "
            f"(B={batch['tokens'].shape[0]} S={batch['tokens'].shape[1]}) "
            f"{row['pallas'][0]:.5f} (mean {row['pallas'][1]:.5f}) in bf16")
    for what, rel, tol in (
            ("one-shot vs token-wise, bf16", gaps[n]["bf16"][0],
             PREFILL_REL_TOL),
            ("one-shot vs token-wise, fp32", gaps[n]["fp32"][0],
             PREFILL_FP32_REL_TOL),
            ("use_pallas True vs False, bf16", gaps[n]["pallas"][0],
             PREFILL_REL_TOL)):
        if not rel <= tol:
            raise AssertionError(f"{arch}, {n} layers: {what} {rel:.7f} of "
                                 f"the logit range > {tol}")
    log("prefill", f"{arch}, first {n} layers: bf16 gaps within "
        f"{PREFILL_REL_TOL}, fp32 within {PREFILL_FP32_REL_TOL} of the logit "
        f"range (checked)")


def expected_launches(cfg) -> dict:
    """Kernel launches one ``api.prefill`` of ``cfg`` must make."""
    want = dict.fromkeys(_ops_modules(), 0)
    if cfg.layout in ("dense", "moe"):
        want["flash_attention"] = cfg.n_layers
    if cfg.layout == "moe":
        want["moe_gating"] = cfg.n_layers
    if cfg.layout == "rwkv":
        want["rwkv6"] = cfg.n_layers
    if cfg.layout == "mamba_hybrid":
        want["mamba2"] = cfg.n_layers
        want["flash_attention"] = cfg.n_layers // cfg.attn_every
    return want


def drive_prefill(dev, arch, model, cfg, b: int, s: int, rng) -> tuple:
    """``api.prefill`` at (b, s) with the counts set to 0 just before and
    read just after (the launches must be ``expected_launches``, the
    logits finite), then timed over two more calls.  Returns (launches,
    the batch)."""
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import api

    batch = {"tokens": torch.from_numpy(
        rng.integers(3, tok.VOCAB_SIZE, (b, s)).astype(np.int32)).to(dev)}
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    logits = api.prefill(model, batch, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = read_launches()
    want = expected_launches(cfg)
    if launches != want:
        raise AssertionError(f"prefill {arch}: launches {launches}, "
                             f"expected {want}")
    # every model prefill here runs in bf16: the tensor-core flash kernel
    route = (" (flash: all on the wgmma route)"
             if check_flash_route(f"prefill {arch}", "wgmma") else "")
    if (tuple(logits.shape) != (b, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"prefill {arch}: logits of shape "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    reps = 2
    t = time.perf_counter()
    for _ in range(reps):
        api.prefill(model, batch, cfg)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t) / reps
    log("prefill", f"{arch} B={b} S={s}: launches "
        f"{ {k: v for k, v in launches.items() if v} }{route}; logits "
        f"{tuple(logits.shape)} finite; {sec * 1e3:.3f} ms per prefill "
        f"({b * s / sec:.1f} prompt tok/s; first call "
        f"{first_s * 1e3:.3f} ms)")
    return launches, batch


def prefill_phase(dev, engines) -> dict:
    """``api.prefill`` on each served model at full width (the serving
    engines' own weights and ``use_pallas=True`` configs), each driven with
    the counts set to 0 just before and read just after; then qwen2-moe's
    one-shot logits against its chunked prefill and its plain path, and
    rwkv6's against its token-wise path and its plain path, at the first
    layers."""
    rng = np.random.default_rng(17)
    total, batches = dict.fromkeys(_ops_modules(), 0), {}
    for arch, b, s in PREFILL_CASES:
        eng = engines[arch]
        launches, batches[arch] = drive_prefill(dev, arch, eng.params,
                                                eng.cfg, b, s, rng)
        total = {k: total[k] + v for k, v in launches.items()}
    moe_prefill_check(dev, engines[MOE_ARCH].params, engines[MOE_ARCH].cfg,
                      batches[MOE_ARCH])
    recurrent_prefill_check(dev, RWKV_ARCH, engines[RWKV_ARCH].params,
                            engines[RWKV_ARCH].cfg, batches[RWKV_ARCH])
    return total


# ---------------------------------------------------------------------------
# 7. the Mamba2 hybrid at full width: one-shot prefill and an engine
# ---------------------------------------------------------------------------


def hybrid_phase(dev) -> dict:
    """zamba2-7b at full width (bf16, ``use_pallas=True``, random weights
    from a seed): its one-shot prefill through the SSD and flash kernels,
    the recurrent checks, then a ``ModelEngine`` on the same weights
    serving ``HYBRID_REQUESTS`` token-wise.  Returns the prefill's
    launches."""
    from repro_torch.configs import for_mode, get_config
    from repro_torch.core.types import Query
    from repro_torch.data import stream as stream_lib
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import api
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.request import Request

    torch.cuda.reset_peak_memory_stats(dev)
    cfg = for_mode(get_config(HYBRID_ARCH, vocab_size=tok.VOCAB_SIZE,
                              max_seq_len=SERVE_MAX_LEN, use_pallas=True),
                   "serve")
    t = time.perf_counter()
    model = api.init_params(cfg, seed=len(SERVE_ARCHS), device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    log("hybrid", f"{HYBRID_ARCH}: {cfg.n_layers}/{cfg.n_layers} Mamba2 "
        f"layers (no depth cut), d_model {cfg.d_model}, d_inner "
        f"{cfg.ssm_expand * cfg.d_model}, ssm_state {cfg.ssm_state}, shared "
        f"attention {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim} "
        f"and d_ff {cfg.d_ff} at {cfg.n_layers // cfg.attn_every} sites; "
        f"{n_params / 1e9:.3f} B params, {weights} bytes in bf16, built in "
        f"{time.perf_counter() - t:.2f} s")
    rng = np.random.default_rng(31)
    launches, batch = drive_prefill(dev, HYBRID_ARCH, model, cfg,
                                    *HYBRID_PREFILL, rng)
    recurrent_prefill_check(dev, HYBRID_ARCH, model, cfg, batch)
    del batch
    torch.cuda.empty_cache()

    n_req, n_prompt, n_new = HYBRID_REQUESTS
    eng = ModelEngine(HYBRID_ARCH, cfg, max_batch=n_req,
                      max_len=SERVE_MAX_LEN, params=model,
                      detokenize=tok.decode, prefill_chunk=SERVE_CHUNK,
                      device=dev)
    reqs = [Request(query=Query(uid=q.uid, text=q.text),
                    prompt_tokens=tok.encode(q.text)[:n_prompt],
                    max_new_tokens=n_new)
            for q in stream_lib.make_stream(per_task=1, seed=3)[:n_req]]
    eng.submit_many(reqs)
    reset_launches()
    done, t = [], time.perf_counter()
    while eng.pending:
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    serve_launches = read_launches()
    if len(done) != n_req or eng.nonfinite_ticks:
        raise AssertionError(f"{HYBRID_ARCH} engine: {len(done)}/{n_req} "
                             f"answered, {eng.nonfinite_ticks} ticks with "
                             f"non-finite logits")
    if (eng.prefill_chunk != 1 or eng.tick_counts["chunk"]
            or serve_launches["mamba2"] or serve_launches["flash_attention"]
            or serve_launches["decode_attention"]):
        raise AssertionError(f"{HYBRID_ARCH} engine: chunk "
                             f"{eng.prefill_chunk}, ticks {eng.tick_counts}, "
                             f"launches {serve_launches}: not token-wise")
    n_d, s_d = eng.tick_counts["decode"], eng.tick_seconds["decode"]
    prompt = sum(len(r.prompt_tokens) for r in reqs)
    log("hybrid", f"{HYBRID_ARCH} engine: {len(done)}/{n_req} requests "
        f"answered ({prompt} prompt tokens fed token-wise, "
        f"{sum(r.output_tokens for r in done)} tokens generated) in "
        f"{wall:.3f} s; {n_d} decode ticks, {s_d / max(n_d, 1) * 1e3:.3f} ms "
        f"each, {prompt / max(n_d, 1):.3f} prompt tokens and "
        f"{eng.decode_tokens['decode'] / max(n_d, 1):.3f} decode tokens per "
        f"tick; finite logits; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} bytes")
    return launches


# ---------------------------------------------------------------------------
# 8. gemma3-12b at full width: one-shot prefill, lockstep decode over ring
#    and full-depth caches, and an engine
# ---------------------------------------------------------------------------


def fill_cache_(cache, gen) -> None:
    """Every KV entry of ``cache`` from ``gen`` (seeded), in place: the
    work of a decode step does not depend on the cache's contents, as the
    JAX package's dry-run ``decode_32k`` fills its caches with random
    values."""
    for name, t in cache.items():
        if name != "length":
            t.normal_(generator=gen)


def lockstep_cache(dev, cfg, src, length: int) -> dict:
    """A cache for ``cfg`` (cut to its first layers) holding copies of the
    first layers' entries of ``src`` in ``cfg``'s compute dtype, at the 0-d
    ``length``."""
    n_local = sum(w < src["k_global"].shape[2]
                  for w in cfg.layer_windows(src["k_global"].shape[2]))
    n_global = cfg.n_layers - n_local
    cut = {k: src[k][:n_local] for k in ("k_local", "v_local")}
    cut.update({k: src[k][:n_global] for k in ("k_global", "v_global")})
    cache = {k: v.to(cfg.torch_dtype(), copy=True) for k, v in cut.items()}
    cache["length"] = torch.full((), length, dtype=torch.int32, device=dev)
    return cache


def lockstep_decode(dev, model, cfg) -> dict:
    """The main path of lockstep decode: ``GEMMA_DECODE``'s steps from a
    filled cache at a 0-d length, counts set to 0 just before and read just
    after.  Returns the launches, the step times and the cache."""
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import api

    b, depth, length, steps = GEMMA_DECODE
    torch.cuda.reset_peak_memory_stats(dev)
    cache = api.init_cache(cfg, b, depth, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    fill_cache_(cache, gen)
    cache["length"] = torch.full((), length, dtype=torch.int32, device=dev)
    kv_bytes = {k: v.numel() * v.element_size() for k, v in cache.items()
                if k != "length"}
    rng = np.random.default_rng(43)
    tokens = torch.from_numpy(rng.integers(3, tok.VOCAB_SIZE, (steps, b, 1))
                              .astype(np.int32)).to(dev)
    torch.cuda.synchronize()
    reset_launches()
    step_ms = []
    for t in range(steps):
        t0 = time.perf_counter()
        logits, cache = api.serve_step(model, tokens[t], cache, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    n_global = cache["k_global"].shape[0]
    want = dict.fromkeys(_ops_modules(), 0)
    want["decode_attention"] = n_global * steps
    if launches != want:
        raise AssertionError(f"{GEMMA_ARCH} lockstep decode: launches "
                             f"{launches}, expected {want}")
    if (cache["length"].ndim != 0 or int(cache["length"]) != length + steps
            or tuple(logits.shape) != (b, 1, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{GEMMA_ARCH} lockstep decode: length "
                             f"{cache['length']}, logits "
                             f"{tuple(logits.shape)} finite "
                             f"{bool(torch.isfinite(logits).all())}")
    rest = step_ms[1:]
    mean = sum(rest) / len(rest)
    dev_ms, top = profile_steps(model, cfg, cache,
                                tokens[:GEMMA_PROFILE_STEPS])
    log("gemma3", f"lockstep decode B={b}, cache depth {depth} (rings "
        f"{kv_bytes['k_local'] + kv_bytes['v_local']} bytes for "
        f"{cache['k_local'].shape[0]} local layers of window "
        f"{cache['k_local'].shape[2]}, full-depth "
        f"{kv_bytes['k_global'] + kv_bytes['v_global']} bytes for "
        f"{n_global} global layers), 0-d length {length} → "
        f"{int(cache['length'])}: {steps} serve_steps, first "
        f"{step_ms[0]:.3f} ms, then {mean:.3f} ms per step (median "
        f"{sorted(rest)[len(rest) // 2]:.3f}, min {min(rest):.3f}, max "
        f"{max(rest):.3f}), {b * 1e3 / mean:.1f} tokens/s; decode_attention "
        f"launches {launches['decode_attention']} ({n_global} per step), "
        f"no other kernel; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} bytes")
    log("profile", f"gemma3 lockstep decode, {GEMMA_PROFILE_STEPS} more "
        f"steps under torch.profiler: {dev_ms:.3f} ms of kernels per step, "
        f"card busy {dev_ms / mean:.4f} of the main run's mean step")
    for line in top:
        log("profile", line)
    return {"launches": launches, "step_ms": step_ms, "cache": cache}


def profile_steps(model, cfg, cache, tokens) -> tuple:
    """Kernel time per lockstep step on the card (torch.profiler, device
    activity only) over ``len(tokens)`` steps after the main run: (ms per
    step, log lines of the top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import api

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in tokens:
            api.serve_step(model, t, cache, cfg)
        torch.cuda.synchronize()
    return kernel_times(prof, len(tokens), "gemma3 lockstep decode")


def lockstep_pallas_gap(dev, model, cfg, cache) -> tuple:
    """One lockstep ``serve_step`` from copies of the same filled cache
    with ``use_pallas`` True (the decode kernel at the global layers) and
    False (``decode_attend``): (their logit gap, the kernel's launches)."""
    from repro_torch.models import api

    length = int(cache["length"])
    tokens = torch.arange(3, 3 + cache["k_local"].shape[1], device=dev,
                          dtype=torch.int32)[:, None]
    outs = []
    reset_launches()
    for use_pallas in (True, False):
        c = dataclasses.replace(cfg, use_pallas=use_pallas)
        outs.append(api.serve_step(model, tokens,
                                   lockstep_cache(dev, c, cache, length),
                                   c)[0][:, 0])
    launches = read_launches()["decode_attention"]
    return logit_gap(outs[1], outs[0]), launches


def feed_gaps(dev, model, cfg, n: int, depth: int) -> tuple:
    """Feed ``n`` seeded tokens (B=2) one at a time through
    ``api.serve_step`` in lockstep (a 0-d length from 0) into a
    ``depth``-deep cache — rings of the window for the local layers, which
    wrap once n > window, and the decode kernel at every global layer,
    every step — and hold each step's logits against one-shot
    ``api.forward`` at the same position: (the gap at every position as
    max |diff| over the position's logit range, worst row; decode kernel
    launches; seconds per step; the cache after the feed; the tokens)."""
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import api

    rng = np.random.default_rng(47)
    toks = torch.from_numpy(rng.integers(3, tok.VOCAB_SIZE, (2, n))
                            .astype(np.int32)).to(dev)
    cache = api.init_cache(cfg, 2, depth, dev)
    cache["length"] = torch.zeros((), dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    outs, t = [], time.perf_counter()
    for i in range(n):
        out, cache = api.serve_step(model, toks[:, i:i + 1], cache, cfg)
        outs.append(out[:, 0])
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t) / n
    launches = read_launches()["decode_attention"]
    token_wise = torch.stack(outs, 1).float()
    one = api.forward(model, {"tokens": toks}, cfg).logits.float()
    gaps = ((token_wise - one).abs().amax(-1)
            / one.abs().amax(-1)).amax(0).cpu().numpy()
    return gaps, launches, sec, cache, toks


def view_cache_gap(view, cfg, cache, toks) -> float:
    """A one-layer view's cache after ``feed_gaps`` against the K/V that
    one-shot attention computes for the same tokens (the layer's input is
    the embedding, the same on both paths): the ring must hold, in slot
    i, the last position p with p % W == i; a full-depth cache positions
    0..n-1.  Max |diff| over the range of the one-shot K or V."""
    from repro_torch.models import attention
    from repro_torch.models.layers import embed, rms_norm

    layer = view.layers[0]
    b, n = toks.shape
    x = rms_norm(embed(view.embed, toks, cfg.torch_dtype()), layer.norm_attn,
                 cfg.norm_eps)
    pos = torch.arange(n, dtype=torch.int32, device=toks.device).expand(b, n)
    _, k, v = attention.project_qkv(layer.attn, x, pos, cfg)
    if cache["k_local"].shape[0]:
        w = cache["k_local"].shape[2]
        slot = torch.arange(w, device=toks.device)
        where = (n - 1) - ((n - 1 - slot) % w)       # position in each slot
        got, want = (cache["k_local"][0], cache["v_local"][0]), (k[:, where],
                                                                 v[:, where])
    else:
        got = (cache["k_global"][0][:, :n], cache["v_global"][0][:, :n])
        want = (k, v)
    return max(float((g.float() - r.float()).abs().max()
                     / r.float().abs().max()) for g, r in zip(got, want))


def gemma3_checks(dev, model, cfg, cache) -> None:
    """Checked, in bf16 and on the same weights upcast in fp32, at 0.05
    (bf16) and 1e-4 (fp32) of the logit range:
    - at the first ``GEMMA_CHECK_DEPTH`` layers (5 rings and one global
      layer): one lockstep step with ``use_pallas`` True vs False from the
      filled caches;
    - the ring-wrapping feed of ``GEMMA_FEED`` against one-shot
      attention in one-layer views of that group — its first ring layer
      (the 1024-slot ring wraps) and its global layer (the decode kernel
      every step): the cache after the feed against the one-shot K/V
      (each ring slot must hold the last position that maps to it), and
      the logits against one-shot ``api.forward`` at the median of the
      per-position gaps past the window — a wrong slot or mask after the
      wrap moves every one of them — and their maximum over the whole feed
      at ``GEMMA_FEED_MAX_TOL``, which a fault at a few positions moves
      (one layer at full width with random weights already amplifies fp32
      rounding a hundredfold at single positions: PERF.md).
    Printed, not checked: the full-depth gaps in bf16 (``use_pallas`` from
    the filled caches, a ``GEMMA_FULL_FEED``-token feed); a random stack
    amplifies rounding along the sequence and with depth (PERF.md)."""
    n, (feed, depth) = GEMMA_CHECK_DEPTH, GEMMA_FEED
    view, cut = layers_view(model, cfg, range(n))
    m32, cut32 = upcast(dev, view, cut)
    p = cfg.local_per_global + 1
    fails = []
    for label, m, c, tol in (("bf16", view, cut, PREFILL_REL_TOL),
                             ("fp32", m32, cut32, PREFILL_FP32_REL_TOL)):
        pallas, n_pallas = lockstep_pallas_gap(dev, m, c, cache)
        if n_pallas != 1:
            raise AssertionError(f"{GEMMA_ARCH}, first {n} layers, {label}: "
                                 f"{n_pallas} decode_attention launches in "
                                 f"one use_pallas step")
        log("gemma3", f"first {n} layers, {label}: use_pallas True vs False "
            f"from the filled caches (B={cache['k_local'].shape[1]}, length "
            f"{int(cache['length'])}) max |diff| {pallas[0]:.7f} of the logit "
            f"range (mean {pallas[1]:.7f}); limit {tol}")
        if not pallas[0] <= tol:
            fails.append(f"{label} use_pallas {pallas[0]:.7f} > {tol}")
        for what, index, lpg in (("ring layer", 0, p - 1),
                                 ("global layer", p - 1, 0)):
            lv, lc = layers_view(m, c, [index], local_per_global=lpg)
            gaps, launches, sec, fed, toks = feed_gaps(dev, lv, lc, feed,
                                                       depth)
            # the one-shot forward of the feed: bf16 on the tensor cores,
            # fp32 on the scalar kernel
            check_flash_route(f"{GEMMA_ARCH} {what} {index}, {label}",
                              "wgmma" if label == "bf16" else "scalar")
            kv_gap = view_cache_gap(lv, lc, fed, toks)
            del fed
            want = feed if what == "global layer" else 0
            if launches != want:
                raise AssertionError(f"{GEMMA_ARCH} {what} {index}, {label}: "
                                     f"{launches} decode_attention launches "
                                     f"in a feed of {feed}, expected {want}")
            past = float(np.median(gaps[c.window:]))
            top, max_tol = float(gaps.max()), GEMMA_FEED_MAX_TOL[label]
            log("gemma3", f"{what} {index} alone, {label}: lockstep feed of "
                f"{feed} tokens into a {depth}-deep cache: cache vs one-shot "
                f"K/V {kv_gap:.7f} of their range; logits vs one-shot "
                f"forward, per-position gap: median past position "
                f"{c.window} {past:.7f} (limit {tol} for both), 90th "
                f"percentile {np.percentile(gaps[c.window:], 90):.7f}, max "
                f"past it {float(gaps[c.window:].max()):.7f}, max {top:.7f} "
                f"at {int(gaps.argmax())} (limit {max_tol}), last "
                f"{gaps[-1]:.7f}; {launches} decode launches, "
                f"{sec * 1e3:.3f} ms per step")
            for name, gap, lim in (("K/V", kv_gap, tol),
                                   ("logits", past, tol),
                                   ("largest logit gap", top, max_tol)):
                if not gap <= lim:
                    fails.append(f"{label} {what} {index} {name} {gap:.7f} "
                                 f"> {lim}")
    del m32
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{GEMMA_ARCH} checks: {'; '.join(fails)}")
    log("gemma3", f"first group: bf16 gaps within {PREFILL_REL_TOL}, fp32 "
        f"within {PREFILL_FP32_REL_TOL} of the logit range, largest feed "
        f"gaps within {GEMMA_FEED_MAX_TOL} (checked)")
    pallas, _ = lockstep_pallas_gap(dev, model, cfg, cache)
    gaps, _, sec, _, _ = feed_gaps(dev, model, cfg, GEMMA_FULL_FEED, depth)
    log("gemma3", f"full depth ({cfg.n_layers} layers), bf16, not checked: "
        f"use_pallas True vs False {pallas[0]:.5f} of the logit range "
        f"(mean {pallas[1]:.5f}); lockstep feed of {GEMMA_FULL_FEED} "
        f"tokens vs one-shot forward, gap at the last position "
        f"{gaps[-1]:.5f} (max {gaps.max():.5f}), {sec * 1e3:.3f} ms per step")


def gemma3_engine(dev, model, cfg) -> None:
    """A ``ModelEngine`` on gemma3's weights at ``GEMMA_ENGINE_MAX_LEN``
    (deeper than the window: ring caches, no ``k`` entry), serving
    ``GEMMA_REQUESTS`` token-wise through per-slot lengths — the plain
    decode attention, never the kernel, as in the JAX package."""
    from repro_torch.core.types import Query
    from repro_torch.data import stream as stream_lib
    from repro_torch.data import tokenizer as tok
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.request import Request

    n_req, n_prompt, n_new = GEMMA_REQUESTS
    eng = ModelEngine(GEMMA_ARCH, cfg, max_batch=n_req,
                      max_len=GEMMA_ENGINE_MAX_LEN, params=model,
                      detokenize=tok.decode, prefill_chunk=SERVE_CHUNK,
                      device=dev)
    reqs = [Request(query=Query(uid=q.uid, text=q.text),
                    prompt_tokens=tok.encode(q.text)[:n_prompt],
                    max_new_tokens=n_new)
            for q in stream_lib.make_stream(per_task=1, seed=3)[:n_req]]
    eng.submit_many(reqs)
    reset_launches()
    done, t = [], time.perf_counter()
    while eng.pending:
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_launches()
    if len(done) != n_req or eng.nonfinite_ticks:
        raise AssertionError(f"{GEMMA_ARCH} engine: {len(done)}/{n_req} "
                             f"answered, {eng.nonfinite_ticks} ticks with "
                             f"non-finite logits")
    if ("k" in eng.cache or eng.prefill_chunk != 1
            or eng.tick_counts["chunk"] or any(launches.values())):
        raise AssertionError(f"{GEMMA_ARCH} engine: cache "
                             f"{sorted(eng.cache)}, chunk "
                             f"{eng.prefill_chunk}, ticks {eng.tick_counts}, "
                             f"launches {launches}: not token-wise on rings")
    n_d, s_d = eng.tick_counts["decode"], eng.tick_seconds["decode"]
    prompt = sum(len(r.prompt_tokens) for r in reqs)
    log("gemma3", f"engine at max_len {GEMMA_ENGINE_MAX_LEN} (rings "
        f"{tuple(eng.cache['k_local'].shape)}, global "
        f"{tuple(eng.cache['k_global'].shape)}): {len(done)}/{n_req} "
        f"requests answered ({prompt} prompt tokens fed token-wise, "
        f"{sum(r.output_tokens for r in done)} tokens generated) in "
        f"{wall:.3f} s; {n_d} decode ticks, {s_d / max(n_d, 1) * 1e3:.3f} ms "
        f"each; finite logits; no kernel launched")


def gemma3_phase(dev) -> dict:
    """gemma3-12b at full width (bf16, ``use_pallas=True``, random weights
    from a seed): its one-shot prefill through the flash kernel at hd 256,
    lockstep decode through the decode-attention kernel, the first-group
    checks and the engine.  Returns the prefill's and the lockstep
    decode's launches."""
    from repro_torch.configs import for_mode, get_config
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import api

    cfg = for_mode(get_config(GEMMA_ARCH, vocab_size=tok.VOCAB_SIZE,
                              use_pallas=True), "serve")
    t = time.perf_counter()
    model = api.init_params(cfg, seed=len(SERVE_ARCHS) + 1, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    windows = cfg.layer_windows(GEMMA_DECODE[1])
    log("gemma3", f"{GEMMA_ARCH}: {cfg.n_layers}/{cfg.n_layers} layers (no "
        f"depth cut; {sum(w < GEMMA_DECODE[1] for w in windows)} local of "
        f"window {cfg.window}, {sum(w == GEMMA_DECODE[1] for w in windows)} "
        f"global), d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} "
        f"heads of {cfg.head_dim}, d_ff {cfg.d_ff}, tied embeddings; "
        f"{n_params / 1e9:.3f} B params, {weights} bytes in bf16, built in "
        f"{time.perf_counter() - t:.2f} s")
    rng = np.random.default_rng(53)
    prefill, batch = drive_prefill(dev, GEMMA_ARCH, model, cfg,
                                   *GEMMA_PREFILL, rng)
    del batch
    torch.cuda.empty_cache()
    run = lockstep_decode(dev, model, cfg)
    t = time.perf_counter()
    gemma3_checks(dev, model, cfg, run["cache"])
    del run["cache"]
    torch.cuda.empty_cache()
    log("gemma3", f"checks {time.perf_counter() - t:.2f} s")
    gemma3_engine(dev, model, cfg)
    return {"prefill": prefill, "decode": run["launches"]}


# ---------------------------------------------------------------------------
# 9. bf16 vs fp32 on two full-width granite layers
# ---------------------------------------------------------------------------


def engine_crosscheck(dev) -> None:
    from repro_torch.configs import for_mode, get_config
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import lm

    cfg16 = for_mode(get_config("granite-3-8b", n_layers=2,
                                vocab_size=tok.VOCAB_SIZE), "serve")
    cfg32 = dataclasses.replace(cfg16, dtype="float32",
                                param_dtype="float32")
    m16 = lm.init_lm(cfg16, seed=3, device=dev)
    m32 = lm.DecoderLM(cfg32, dev)
    with torch.no_grad():
        for p32, p16 in zip(m32.parameters(), m16.parameters()):
            p32.copy_(p16.float())
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(3, tok.VOCAB_SIZE, (2, 8))
                              .astype(np.int32)).to(dev)
    n_active = torch.tensor([8, 5], dtype=torch.int32, device=dev)
    nxt = torch.from_numpy(rng.integers(3, tok.VOCAB_SIZE, (2, 1))
                           .astype(np.int32)).to(dev)
    outs = []
    for model, cfg in ((m16, cfg16), (m32, cfg32)):
        cache = lm.init_cache(cfg, 2, 64, dev)
        a, cache = lm.prefill_chunk_step(model, tokens, cache, cfg, n_active)
        b, cache = lm.decode_step(model, nxt, cache, cfg)
        outs.append((a.float(), b.float()))
    (a16, b16), (a32, b32) = outs
    for name, lo, hi in (("prefill slot 0", a16[0], a32[0]),
                         ("prefill slot 1", a16[1, :5], a32[1, :5]),
                         ("decode", b16, b32)):
        if not (torch.isfinite(lo).all() and torch.isfinite(hi).all()):
            raise AssertionError(f"engine cross-check {name}: non-finite")
        rel = float((lo - hi).abs().max() / hi.abs().max())
        mean_rel = float((lo - hi).abs().mean() / hi.abs().mean())
        if not rel <= BF16_REL_TOL:
            raise AssertionError(f"engine cross-check {name}: bf16 vs fp32 "
                                 f"{rel:.4f} of the logit range > "
                                 f"{BF16_REL_TOL}")
        log("crosscheck", f"{name}: bf16 vs fp32 max |diff| {rel:.5f} of the "
            f"logit range (tolerance {BF16_REL_TOL}), mean |diff| "
            f"{mean_rel:.5f} of the mean |logit|")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the "
              "card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the repro_torch package is not at {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    t_start = time.perf_counter()
    t = time.perf_counter()
    feat = featurize_phase(dev)
    lin = linucb_phase(dev)
    gate = gating_phase(dev)
    flash = flash_phase(dev)
    wkv = wkv_phase(dev)
    ssd = ssd_phase(dev)
    scan_sass()
    decode = decode_phase(dev)
    log("kernels", f"phase {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    router_phase(dev)
    log("router", f"phase {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    launches, engines = serving_phase(dev)
    log("serve", f"phase {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    prefill = prefill_phase(dev, engines)
    del engines
    torch.cuda.empty_cache()
    log("prefill", f"phase {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    hybrid = hybrid_phase(dev)
    torch.cuda.empty_cache()
    log("hybrid", f"phase {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    gemma3 = gemma3_phase(dev)
    torch.cuda.empty_cache()
    log("gemma3", f"phase {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    engine_crosscheck(dev)
    log("crosscheck", f"phase {time.perf_counter() - t:.2f} s")
    log("total", f"{time.perf_counter() - t_start:.2f} s after the build")

    # the serving path routes admission batches of one: the router kernels'
    # rows are at Q = 1; its MoE decode ticks gate T = 4 rows.  The flash
    # row is granite's one-shot prefill (B = 2, S = 2048), the WKV row
    # rwkv6's (B = 2, S = 2048), the SSD row zamba2's (B = 1, S = 4096);
    # their launches are the one-shot prefills' (flash: the four served
    # models', zamba2's 13 sites and gemma3's 48 layers).  The decode
    # attention row is gemma3's global layers in lockstep decode (B = 4,
    # cache_len 32705 of 32768), its launches those of the 32 steps
    f1 = next(r for r in feat["rows"] if r["label"] == "mode=both Q=1")
    l1 = next(r for r in lin["rows"] if r["label"] == "M=4 d=12 Q=1")
    g4 = next(r for r in gate["rows"] if r["t"] == 4 and not r["tied"])
    fa = flash["rows"][0]
    da = decode["rows"][0]

    def row(name, src, replaces, n, worst, r, library_ms=None):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{src}",
                "replaces": f"src/repro/kernels/{replaces}",
                "launches": n, "max_abs_err": worst, "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": library_ms,
                "device_ms": r.get("device_ms")}

    kernels = [
        row("featurize", "featurize.cu", "featurize/kernel.py:37",
            launches["featurize"], feat["worst"], f1),
        row("linucb", "linucb.cu", "linucb/kernel.py:25",
            launches["linucb"], lin["worst"], l1),
        row("moe_gating", "moe_gating.cu", "moe_gating/kernel.py:23",
            launches["moe_gating"], gate["worst"], g4),
        row("flash_attention", "flash_attention.cu",
            "flash_attention/kernel.py:33",
            prefill["flash_attention"] + hybrid["flash_attention"]
            + gemma3["prefill"]["flash_attention"],
            flash["worst"], fa, fa["library_ms"]),
        row("rwkv6", "rwkv6.cu", "rwkv6/kernel.py:25", prefill["rwkv6"],
            wkv["worst"], wkv["rows"][0]),
        row("mamba2", "mamba2.cu", "mamba2/kernel.py:25", hybrid["mamba2"],
            ssd["worst"], ssd["rows"][0]),
        row("decode_attention", "decode_attention.cu",
            "decode_attention/kernel.py:29",
            gemma3["decode"]["decode_attention"], decode["worst"], da,
            da["library_ms"]),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"the main path never launched {k['name']}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
