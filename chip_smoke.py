#!/usr/bin/env python3
"""Drive the PyTorch port of GreenServ on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels: the wrappers of featurize, LinUCB, MoE gating, flash
     attention, the RWKV6 WKV scan, the Mamba2 SSD scan and decode
     attention against their plain PyTorch versions on the card
     (featurize 1e-5 at the router's batches of Q = 1, 2, 4, 16, 25, 64
     and 256, a prompt of L = 4096 and edge rows: ids past H between
     -1s, a repeated bucket, featureless rows exactly 0; LinUCB 1e-4 at
     d = 12 with the served pool's 4 arms and 64 (Q = 1, 2, 4, 16, 64),
     the paper pool's 32 and RouterBench's 16, d = 128 at Q = 1024 and
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
     and decode attention on the card too; the families phase's shapes:
     flash at whisper-medium's encoder (non-causal, 16/16 heads of 64,
     S = 1500) and decoder, llava-next-34b's prefill and gemma3-27b's
     local and global layers, decode attention at gemma3-27b's global
     layers, gating at grok's E = 8, k = 2;
  4. router: one 64-query stream through twin routers on the card, device
     featurize vs host featurize — arms, labels, clusters and bins must be
     identical;
  4b. the paper's closed loop (``repro_torch.benchmarks``), every router
     on the card with ``featurize="auto"`` (the device path for LinUCB):
     (a) the replay over the 16-model pool at T = 2,500 — GreenServ
     (LinUCB), random, largest, smallest, best, non-contextual and
     contextual ε-greedy — with every assertion of
     tests/test_paper_claims.py, decision ms < 25 included; (b) device vs
     host featurize at T = 750, identical traces; (c) gemma-3-12b held
     out and joining at query 1,000 (§6.2.4); (d) 750 queries through
     ``PoolServer`` over 16 ``SimEngine``s, every one answered; (e) the
     RouterBench sweep at its --smoke size (linucb, eps_greedy_ctx, cts);
     (f) the ``ctx-thompson`` row at T = 2,500 beside the JAX package's
     CPU numbers, and at T = 150 on the card and the CPU side by side,
     identical arms and key; (g) LinUCB's Cholesky mode against
     Sherman–Morrison at M = 32, d = 12, scores at 2e-4, the same arms,
     one decision timed in each.  One featurize and one LinUCB launch per
     device-path routing call, one LinUCB launch per host-path
     Sherman–Morrison call, none for ε-greedy, CTS or the Cholesky mode;
  5. serving: ``PoolServer`` over four full-width engines cut in depth
     (``SERVE_CUTS``: granite-3-8b at 10 of its 40 layers, rwkv6-1.6b,
     qwen2-moe-a2.7b and h2o-danube-3-4b at 8 of their 24; bf16,
     ``use_pallas=True``, random weights from a seed) on a synthetic
     query stream plus a decode slice of short prompts — every query
     answered, finite logits, the router kernels and the gating kernel
     launched by the main path (a gating launch per MoE layer a tick), real
     decode work, rwkv6 fed its prompts token-wise; a slice of the decode
     prompts goes straight into any engine the router sent fewer than 4
     queries — with three windows of the run under torch.profiler for the
     card's busy share and the top kernels;
  5b. GreenCache on the serving engines: (a) the admission probe (one
     featurize launch over the stacked rows) against the host features at
     Q = 1, 2, 3, 16 and 60, labels and clusters equal, embeddings 1e-5;
     (b) one-slot granite-3-8b and qwen2-moe-a2.7b engines on the serving
     weights generate the same tokens with a spliced 40-token preamble
     as cold (the first token's logit gap printed), and rwkv6 takes no
     prefix cache; (c) the cache workload (60 queries, Poisson arrivals
     on a virtual clock) through ``PoolServer`` over granite, qwen2-moe
     and danube with the cache off and full (512 blocks, threshold
     0.92): every query answered, semantic and prefix hits, fewer metered
     joules, and featurize launched once per admission batch in both
     modes (in full mode by the probe; the decision reuses its
     embeddings);
  5c. the energy-governed serving path (``repro_torch.launch.serve``,
     ``costmodel``, ``telemetry``): (a) the launcher's default
     configuration (``serve``: 40 queries, prefix cache at 512 blocks,
     the cost model on, telemetry without a governor, featurize "auto")
     over the serving engines' granite-3-8b, rwkv6-1.6b and
     qwen2-moe-a2.7b — every query answered, every forecast reconciled,
     the cost model's prior at each cold response's actual lengths equal
     to its metered Wh within 1e-9, the telemetry's Wh equal to the
     responses' within 1e-6, one featurize and one LinUCB launch per
     routed batch, 24 gating launches per MoE tick, and a host-featurize
     twin router on the card fed the same queries, cost matrices,
     discounts and feedback picking the same arms; the modeled pool
     watts printed beside the card's power draw (nvidia-smi), nothing
     gated on them; (b) the governor at the JAX package's acceptance
     (``tests/test_telemetry.py``): 1,000 queries over 8 paper-pool
     ``SimEngine``s, router on the card, the cap at 60% of the
     ungoverned Wh held, accuracy >= 0.9x, λ above 0.4, the governor's
     Wh equal to the served Wh; the admission planner at a tight budget
     defers and answers every query; (c) the cache workload in full mode
     with the wall-clock governor at the uncached run's spend: every
     query answered, avoided prefix and semantic Wh credited to the
     governor and the export, the final λ printed;
  5d. the serving path under faults, bursts and churn, every router on
     the card with featurize "auto": (a) ``benchmarks/scenarios.py``'s
     flash crowd (per_task 100, planner on, governed at 0.8x the random
     spend), duplicate flood (60) and pool churn (60: qwen2.5-14b killed
     at 30% of the span, gemma-3-12b added at 50%) with each bench's
     checks, the pool churn beside a host-featurize twin router (a copy
     of the router at its first call) picking the same arms in every
     batch, before and after the pool grows from 15 to 16 arms, and the
     baselines' closed loop at its defaults (GreenServ answers all, at
     least random's accuracy, fewer Wh); (b) ``benchmarks/chaos.py``'s
     ``main`` at per_task 60 without the fleet variant (run in 5e; its
     seven invariants) with a host twin of every run's router, equal arms
     in every batch while breakers open and close; (c) disaggregated
     prefill/decode at full width on the serving weights (granite-3-8b,
     qwen2-moe-a2.7b; bf16, ``use_pallas=True``, max_len 192, chunk 8,
     fresh engines): (c1) tests/test_disagg.py's six queries unified and
     as a prefill engine plus a decode twin, each migrated K/V bit-equal
     to the prefill slot and to the twin's slot after the splice; at
     max_batch 1 identical tokens, at 2 every divergence printed with
     its top-two logit gaps and held to a rounding tie or to the path
     that explains it (a unified decode token riding a chunk tick, a
     MoE tick shared with another row); (c2) the disaggregation bench's
     MMPP workload (30 users, its timescales scaled by the modeled decode
     tick, full width over the bench's smoke model) monolithic (4 slots)
     against the pair (2 + 2): every query answered, migrations only
     disaggregated, prefill and decode role Wh; TTFT p50/p95/p99 and
     J/query printed, not gated; (c3) the twin and then the prefill
     engine killed under ``FaultInjector`` crashes: responses and failed
     cover every uid once; (c4) the launcher's ``serve`` with
     ``--disaggregate`` (``--queries 12``: 10 stream queries) over
     granite, rwkv6 and qwen2-moe: every query answered, rwkv6 unified.
     The featurize, LinUCB and gating launches are held to the routing
     calls, cache probes and MoE ticks of each part (host twins' put
     back);
  5e. the fleet (``repro_torch.fleet``), every router on the card: (a)
     ``benchmarks/pool_scale.py --smoke`` ({1, 4} shards of an 8-model
     paper-pool subset on ``SimEngine``s, 150 queries a shard, a shard
     killed at 40% of the 4-shard run's arrivals) with its three
     assertions, once with featurize "auto" (the device path) and once
     "host": the two records equal but for the wall-clock decision time,
     and equal to the JAX package's CPU figures; (b) the fleet chaos
     variant (``chaos.run_fleet_chaos``, 80 queries, three shards, one
     in the fault storm, one killed): the JAX package's CPU record; (c)
     two shards on the card, each a ``PoolServer`` over the serving
     engines' h2o-danube-3-4b and qwen2-moe-a2.7b (shared weights, own
     caches), 32 stream queries with Poisson arrivals on the virtual
     clock, shard 1 killed at 40% of them through ``drive_fleet``: every
     query answered, one fail-over that redispatches stranded queries,
     both adopted ``@shard1`` engines serving on the survivor, the
     all-reduce run, finite logits; the fleet's checkpoint restored into
     a fresh fleet of the same shape routes a 10-query probe as the
     saved fleet does, shard by shard.  One featurize and one LinUCB
     launch per device-path routing call, one LinUCB per host-path call,
     a gating launch per MoE layer and tick;
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
  10. the other families and the paper's remaining experiments, after
     every earlier phase's models are freed: (a) whisper-medium at full
     depth and width (bf16, ``use_pallas=True``): ``api.prefill`` at B=2
     with 1,500 stub frames and S=448 (24 flash launches, the decoder's
     self-attention, all on the wgmma route; the encoder's and the whole
     prefill's ms apart; at 2 layers ``use_pallas`` True vs False on zero
     frames, the serving engine's stub frontend, and printed on N(0, 1)
     frames beside the plain path's own gap for a one-bf16-unit move of
     the frames), served beside granite-3-8b (``SERVE_CUTS``) through the
     launcher's ``serve`` at its defaults (every query answered, whisper
     among the arms), and a prefill engine with its decode twin at
     max_batch 1 against a unified engine (identical tokens, each
     migrated K/V bit-equal); (b) gemma3-27b at 12 of its 62 layers:
     ``api.prefill`` at B=1 S=8192 (12 flash launches), lockstep decode at
     B=4 over a 32768-deep cache (2 decode-attention launches a step) and the
     gemma3 phase's checks; llava-next-34b at 16 of its 60 layers,
     ``api.prefill`` with its 576 stub patch embeddings before 1,024
     text tokens; grok-1-314b at 2 of its 64 layers, ``api.prefill`` at
     B=2 S=2048 (the gating kernel at E=8, k=2) and a 4-request engine
     (a gating launch a layer a tick); (c) the paper benches through the
     port's router on the card: ``lambda_sweep`` and ``features`` at
     per_task 25 with two seeds, ``features --perf --smoke`` (parity),
     ``model_addition``, ``overhead`` and ``prefill`` at their defaults,
     ``energy_model --smoke`` (its MAE gate) at 24 queries a cell, each
     table printed and the router kernels' launches held to each
     bench's routing calls; (d) the benchmark entry points and the
     quickstart: ``telemetry.main(smoke=True)`` at per_task 60 (the < 5%
     telemetry overhead assertion live; its governance lines equal to the
     JAX package's CPU record), ``cache.main(smoke=True)`` at 36 queries
     over the served granite-3-8b (full width, ``SERVE_CUTS``; its smoke
     assertions: >= 30% fewer joules, both hit kinds, the Prometheus
     series, the governor's credit, the carbon deferral),
     ``baselines.main`` and ``routerbench.main`` with ``--smoke`` at the
     smallest closed loops their orderings hold at on the CPU, every line
     equal to the JAX package's CPU record, ``kernels.main``'s four rows
     within the kernel phase's tolerances, and
     ``examples/torch_quickstart.py`` with the reference script's
     accuracy, energy and selection counts exactly.
  11. training (``repro_torch.train``, ``launch/train.py``), after every
     earlier phase's models are freed: (a) rwkv6-1.6b at its full width
     and depth (fp32 storage, bf16 compute, fp32 moments), 12 steps of
     ``make_train_step`` on ``synthetic_batches`` at B=8 S=512, lr 3e-4 —
     losses and grad norms finite, the last loss below the first, no
     kernel launched; the median ms a step, tokens a second and the peak
     memory printed; (b) rwkv6 and qwen2-moe smoke configs in fp32
     compute, the same weights and batches through 3 steps on the card
     and on the CPU (losses 1e-5 relative, every parameter leaf 1e-3
     relative L2; lr and grad norms printed), ``ef_compress`` over 30
     steps and
     ``compressed_psum`` over 8 replicas bit-equal; (c) the launcher's
     ``train`` with tests/test_train.py's injected failure and
     ``examples/torch_train_100m.py`` at its defaults (the loss falls);
     (d) (a)'s trained parameters through ``params_to_jax`` into a
     checkpoint, restored bit-equal into a serving model, ``api.prefill``
     at B=1 S=512 with ``use_pallas=True``: one WKV launch a layer and no
     other, the logits against ``use_pallas=False`` at the prefill
     phase's depth and tolerance (full depth printed), and the WKV
     wrapper refusing a grad-requiring input under grad mode; (e) training
     over the ranks of a process group: (e1) one rank, this process, on
     its card over NCCL, through ``launch.train.train`` at (a)'s model,
     batch, lr and steps — its losses and grad norms bit-equal to (a)'s,
     its ms a step, the mean over the ranks' ms (CUDA events) and its
     peak memory beside (a)'s; (e2) two spawned ranks on the one card
     over gloo (NCCL takes one rank a device): smoke rwkv6 and qwen2-moe
     in fp32 with error feedback, the ranks bit-equal, against this
     process's step on the whole batch — at n_micro 2, whose microbatches
     are the ranks' rows, within (b)'s tolerances; at n_micro 1 within
     limits read on the card — and ``compressed_psum`` over 2 ranks × 4
     replicas bit-equal to the one-device form.  The one-card checks
     build their (1, 1) mesh themselves; the launcher's, in (c), is the
     host mesh, which needs one visible card outside a process group.
  12. the cost walk (``repro_torch.launch.dryrun``), after the train
     phase's models are freed: (a) the records of two one-card cells of
     granite-3-8b at full width and depth (40 layers, bf16 weights),
     ``run_cell`` on the (1, 1) plan: prefill at B=2 S=4096 and lockstep
     ``serve_step`` at B=4 over a 32768-deep cache (a 0-d length);
     ``HBM_PER_CHIP`` held to the card's ``total_memory`` where the card
     is the one it names; (b) the same steps built on the card
     (``train.make_prefill_step``/``make_serve_step`` on the host mesh),
     their FLOPs under ``FlopCounterMode`` with ``use_pallas=False``
     equal to the meta record's; (c) each step timed with CUDA events
     (the median of 5 after a warm-up) with ``use_pallas`` False and True
     (40 flash launches a prefill, 40 decode-attention launches a step,
     counted), printed beside the record's ``t_compute_s``,
     ``t_memory_s`` and ``bottleneck``, ``max_memory_allocated`` beside
     ``peak_bytes_per_dev``; every time at least max(t_compute,
     arg_bytes_per_dev / HBM_BW) / 1.05 (no step beats its FLOPs at the
     bf16 peak or one read of its weights and cache); (d)
     ``benchmarks.roofline.table`` over (a)'s records: two OK rows.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
CUDA device is visible or the package is not beside this script.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
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
# them (mode "both" doubles the rows; Q = 25 is the paper phase's
# drive_pool_stream batch), and LinUCB (M, d, Q): the served pool's 4 arms
# and 64 at the router's d = 12, the production shape of the JAX kernel's
# docstring (src/repro/kernels/linucb/kernel.py:12-13) and a ragged Q, an
# odd M, d = 150 (two column passes), then the paper phase's: the 16-model
# pool's max_arms 32 at Q = 1 (route) and Q = 25 (route_batch), and
# RouterBench's 16 arms at Q = 1; the rows whose launch geometry is
# printed and held against layout()
FEATURIZE_SHAPES = (("both", 1), ("both", 2), ("both", 4), ("both", 16),
                    ("both", 25), ("both", 64), ("both", 256), ("full", 1),
                    ("full", 16), ("full", 64))
FEATURIZE_GEOMETRY_ROWS = ("mode=both Q=1", "mode=both Q=64",
                           "mode=both Q=256")
LINUCB_SHAPES = ((4, 12, 1), (64, 12, 1), (64, 12, 2), (64, 12, 4),
                 (64, 12, 16), (64, 12, 64),
                 (64, 128, 1024), (64, 128, 1000), (37, 128, 3),
                 (16, 150, 64), (32, 12, 1), (32, 12, 25), (16, 12, 1))
LINUCB_GEOMETRY_ROWS = ("M=4 d=12 Q=1", "M=32 d=12 Q=1", "M=64 d=128 Q=1024")
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
BF16_FLOPS = 989e12            # H100 SXM bf16 tensor cores, dense
MOE_ARCH = "qwen2-moe-a2.7b"
RWKV_ARCH = "rwkv6-1.6b"
HYBRID_ARCH = "zamba2-7b"
GEMMA_ARCH = "gemma3-12b"
WHISPER_ARCH = "whisper-medium"
LLAVA_ARCH = "llava-next-34b"
GROK_ARCH = "grok-1-314b"
GEMMA27_ARCH = "gemma3-27b"
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
# the served models at full width and cut in depth, for the script's time
# limit: a scheduler step is eager PyTorch whose host time grows with the
# layers it runs (the serving, cache, energy, resilience and fleet phases
# were 446 s of a 977.7 s run at 40 / 12 / 24 / 24 layers on an H100),
# and rwkv6 feeds every prompt token-wise, a tick a token
SERVE_CUTS = {"granite-3-8b": {"n_layers": 10}, RWKV_ARCH: {"n_layers": 8},
              MOE_ARCH: {"n_layers": 8}, "h2o-danube-3-4b": {"n_layers": 8}}
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
    # the families phase: whisper-medium's encoder shape on the wgmma
    # route, non-causal, MHA at hd 64 and S = 1500 (ragged against both
    # tiles; the model's encoder attends in plain code, as the JAX
    # package's), its decoder's causal self-attention at 448 tokens,
    # llava's 576 stub positions + 1024 text tokens at 64 (padded) / 8
    # heads, and gemma3-27b's local and global layers at hd 128
    (WHISPER_ARCH + " encoder", 1, 1500, 1500, 16, 16, 64, 1500, False,
     torch.bfloat16),
    (WHISPER_ARCH + " decoder", 2, 448, 448, 16, 16, 64, 448, True,
     torch.bfloat16),
    (LLAVA_ARCH, 1, 1600, 1600, 64, 8, 128, 1600, True, torch.bfloat16),
    (GEMMA27_ARCH + " local", 1, 8192, 8192, 32, 16, 128, 1024, True,
     torch.bfloat16),
    (GEMMA27_ARCH + " global", 1, 8192, 8192, 32, 16, 128, 8192, True,
     torch.bfloat16),
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
    # gemma3-27b's global layers in the families phase's lockstep decode
    (GEMMA27_ARCH, 4, 32768, 32, 16, 128, 32705, 32768, torch.bfloat16),
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
# the families phase: whisper-medium's one-shot prefill (batch, decoder
# tokens: whisper's own decoder length; 1,500 stub frames a row);
# llava-next-34b cut to 16 of its 60 layers (64.1 GiB in full) and its
# prefill (batch, text tokens after 576 stub patches); grok-1-314b cut to
# 2 of its 64 layers (9.2 GiB a layer in bf16), its prefill and engine
# (requests, prompt, new tokens); gemma3-27b cut to 12 of its 62 layers
# (two of its global layers; 32.90 s uncut on an H100 with its checks),
# at GEMMA_PREFILL and GEMMA_DECODE; the paper benches' sweeps at per_task 25 (T = 125; their
# default is 200) and two seeds, energy_model at 24 queries a cell (its
# --smoke default 48), the rest at their defaults: the phase's time
WHISPER_PREFILL = (2, 448)
LLAVA_LAYERS, LLAVA_PREFILL = 16, (1, 1024)
GROK_LAYERS, GROK_PREFILL, GROK_REQUESTS = 2, (2, 2048), (4, 32, 16)
GEMMA27_LAYERS = 12
BENCH_SWEEP_PER_TASK, BENCH_RUNS, BENCH_ENERGY_QUERIES = 25, 2, 24
# families phase (d): the benchmark entry points, with the JAX package's
# CPU records (JAX_PLATFORMS=cpu PYTHONPATH=src:. python -c 'from
# benchmarks import bench_telemetry as b; print(b.main(per_task=60))',
# bench_baselines.main(per_task=30, closed_per_task=60, smoke=True,
# artifact=None), bench_routerbench.main(n_per_task=10,
# closed_n_per_task=20, smoke=True, artifact=None); jax 0.9.0).  The
# closed loops are the smallest where --smoke's ordering holds on the CPU
# (baselines: 60 a task, where 10-50 fail; RouterBench: 20, where 10-15
# fail); the offline tables at 30 a task (T = 150) and at RouterBench's
# least, 10 a task (its classifier fits on the table's first 90 queries)
# the train phase: (a) rwkv6-1.6b at its full width and depth (fp32
# storage, bf16 compute, fp32 moments; 25.3 GB of parameters, gradients
# and moments), synthetic_batches at (batch, seq), the steps, lr: the
# launcher's default lr, 3e-4 — at 1e-3 the first Adam steps (every
# weight moved by ~lr after 3 warmup steps) throw the random 24-layer
# stack about and the loss rises over the 12 steps (tools/train_phase.py
# --lr 1e-3 3e-4; PERF.md §6); (b) card == CPU on smoke configs in
# fp32 compute (batch, tokens a row, steps, lr): the losses at
# tests/test_torch_train.py's 1e-5 relative; the parameters at 1e-3
# relative L2 a leaf, not that test's 2e-4 (XLA against PyTorch on the
# CPU, rwkv6 only): cuBLAS sums in other orders, so gradient elements
# that cancel to near zero differ in their low bits, and each Adam step
# divides an element's update by its own magnitude, so such an element
# takes another update on each device; after 3 steps at lr 1e-3 the
# worst leaf read 3.0e-5 (rwkv6's bonus_u) and 3.1e-4 (qwen2-moe's
# embedding, N(0, 0.02) values moved by ~lr a step; MoE routing) on an
# H100, the losses within 4e-6 (PERF.md §6);
# (c) tests/test_train.py's launcher
# call; (d) the trained weights' prefill (B = 1, S) through the WKV kernel
TRAIN_FULL = (8, 512, 12, 3e-4)
TRAIN_PARITY_ARCHS = (RWKV_ARCH, MOE_ARCH)
TRAIN_PARITY = (4, 33, 3, 1e-3)
TRAIN_LOSS_REL = 1e-5
TRAIN_PARAM_REL = 1e-3
TRAIN_LAUNCHER = dict(steps=8, batch=2, seq=32, ckpt_every=3,
                      fail_at_step=5, lr=5e-3)
# (e2)'s smoke configs at TRAIN_PARITY, with error feedback: 2 ranks of
# 2 rows against this process's step on the whole batch of 4, at n_micro 2
# (its microbatches are the ranks' rows, so its products run at the
# ranks' shapes; held at TRAIN_LOSS_REL / TRAIN_PARAM_REL) and at n_micro
# 1 (held at the limits below).  At n_micro 1 the products at 4 rows pick
# other kernels on the card than at 2, and qwen2-moe carries those low
# bits far: Adam moves an element whose gradient cancels near zero by up
# to lr either way, a rounding-level difference moves an element by a
# whole int8 quantum of error feedback, and the routing follows.  Read on
# an H100 80GB HBM3 at 700 W, the same in two runs: the third loss 2.48e-4
# apart, a leaf 6.93e-3 (PERF.md §6); rwkv6 2.87e-7 and 1.74e-5
TRAIN_RANKS = (RWKV_ARCH, MOE_ARCH)
TRAIN_RANKS_WHOLE = {RWKV_ARCH: (TRAIN_LOSS_REL, TRAIN_PARAM_REL),
                     MOE_ARCH: (1e-3, 2e-2)}
HANDOFF_S = 512
COST_ARCH = "granite-3-8b"     # the cost phase's model, full width and depth
COST_CELLS = ((2, 4096, "prefill"), (4, 32768, "decode"))  # (B, S, kind)
COST_REPS = 5                  # timed calls a step and use_pallas setting
COST_SLACK = 1.05              # a step's time >= its spec floor / this
MAIN_TEL_PER_TASK = 60         # bench_telemetry's --smoke per_task
TELEMETRY_JAX = [
    'governance,ungoverned_acc,0.5403',
    'governance,ungoverned_wh,25.555',
    'governance,budget_wh,15.333',
    'governance,governed_acc,0.5399',
    'governance,governed_wh,19.964',
    'governance,under_cap,False',
    'governance,lambda_final,0.800',
    'governance,lambda_adjustments,59',
    'governance,relative_accuracy,0.9992',
]
MAIN_BASELINES = dict(per_task=30, closed_per_task=60)
BASELINES_JAX = [
    'name,mean_norm_accuracy,total_energy_wh,cumulative_regret',
    'greenserv-linucb,0.5416,10.86,13.2',
    'ctx-eps-greedy,0.5709,11.19,13.2',
    'ctx-thompson,0.5726,8.13,9.6',
    'eps-greedy-nonctx,0.5878,14.84,13.0',
    'random,0.5354,12.63,16.3',
    'largest (yi-34b),0.3990,29.71,43.3',
    'smallest (qwen2.5-0.5b),0.3417,1.87,25.0',
    'accuracy (gemma-3-27b),0.7550,46.49,25.5',
    ('# paper targets: +22% acc / -31% energy vs random -> got +1.2% acc, '
     '-14.0% energy'),
    ('closed-loop-greenserv,acc=0.580,wh=9.27,completed=300/300,'
     'cache_hits=103'),
    ('closed-loop-random,acc=0.553,wh=11.70,completed=300/300,'
     'cache_hits=91'),
    'smoke,closed-loop ordering holds,acc 0.580>=0.553,wh 9.27<11.70',
]
MAIN_ROUTERBENCH = dict(n_per_task=10, closed_n_per_task=20)
ROUTERBENCH_JAX = [
    'algorithm,AIQ,peak_acc,avg_acc',
    'greenserv-linucb,0.586,67.8%,55.6%',
    'ctx-eps-greedy,0.494,54.4%,46.7%',
    'thompson,0.669,73.3%,57.0%',
    '# paper Table 1: GreenServ AIQ 0.607 / peak 75.7% / avg 71.7%',
    'closed-loop-greenserv,acc=0.628,wh=1305.0,completed=180/180',
    'closed-loop-random,acc=0.594,wh=1436.8,completed=180/180',
    ('smoke,closed-loop ordering holds,acc 0.628>=0.594,'
     'wh 1305.0<1436.8'),
]
MAIN_CACHE_QUERIES = 36        # bench_cache's --smoke size
# examples/quickstart.py's printed numbers (JAX_PLATFORMS=cpu
# PYTHONPATH=src python examples/quickstart.py; jax 0.9.0)
QUICKSTART_JAX = {"accuracy": "0.605", "energy_wh": "31.9", "selections": {
    "qwen2.5-0.5b": 9, "qwen2.5-1.5b": 21, "qwen2.5-3b": 50,
    "qwen2.5-7b": 11, "qwen2.5-14b": 50, "mistral-7b": 20, "gemma-3-1b": 14,
    "gemma-3-4b": 17, "gemma-3-12b": 84, "gemma-3-27b": 36,
    "llama-3.1-1b": 13, "llama-3.2-3b": 80, "llama-3.1-8b": 56,
    "phi-4-mini-4b": 22, "phi-4-14b": 12, "yi-34b": 5}}
# the paper phase (the paper's closed loop on the 16-model pool, §6):
PAPER_PER_TASK = 500           # T = 2,500, the paper's stream (§6.1.2)
PAPER_TWIN_PER_TASK = 150      # T = 750: device vs host featurize
PAPER_ADD_AT = 1000            # §6.2.4: gemma-3-12b joins at query 1,000
PAPER_SERVE_PER_TASK = 150     # 750 queries through PoolServer
PAPER_SERVE_BATCH = 25         # drive_pool_stream's admission batch
PAPER_RB_PER_TASK = 40         # bench_routerbench's --smoke size
PAPER_DECISION_MS = 25.0       # tests/test_paper_claims.py's bound
# the JAX package's ctx-thompson row from its run_policy on a CPU at T =
# 2,500 (accuracy, Wh, regret; benchmarks/common.py, jax 0.9.0)
CTS_JAX_T2500 = (0.621420, 163.989938, 88.795839)
CTS_TWIN_PER_TASK = 30         # T = 150: CTS on the card vs the CPU path
CTS_TIE = 1e-5                 # a top-two gap below this is a rounding tie
CHOL_ARMS = (32, 16)           # the paper pool: max_arms, live arms
CHOL_UPDATES = 400             # seeded posterior updates before comparing
CHOL_TOL = 2e-4                # tests/test_bandits.py's tolerance
CHOL_DECISIONS = 200           # decisions timed per solve mode
GATING_T = (4, 32, 4096)       # decode tick, chunk tick (4 x 8), a prefill
GROK_GATING_T = (4, 4096)      # grok's E = 8, k = 2: its engine's decode
                               # tick and its prefill (B = 2, S = 2048)
CACHE_ARCHS = ("granite-3-8b", MOE_ARCH, "h2o-danube-3-4b")  # rwkv6 out
CACHE_WARM_ARCHS = ("granite-3-8b", MOE_ARCH)
CACHE_QUERIES = 60             # the cache workload: 60 queries, seed 0
CACHE_BLOCKS = 512             # the launcher's --kv-cache-blocks
CACHE_THRESHOLD = 0.92         # and --semantic-threshold
CACHE_PROBE_Q = (1, 2, 3, 16, 60)  # admission batches the probe is held at
CACHE_PREAMBLE = 40            # a preamble's whole blocks, in tokens
CACHE_WARM_NEW = 8             # tokens generated by the warm/cold check
# the energy phase: the launcher's default run at full width, the
# governor at the JAX package's acceptance settings
# (tests/test_telemetry.py: 60% of the ungoverned Wh, gain 0.005,
# lambda_max 0.75, the paper pool cut to 8 models, batches of 10), the
# planner at its tight budget (tests/test_costmodel.py) and the cache
# workload governed at the uncached run's spend (bench_cache's budget)
ENERGY_QUERIES = 40            # the launcher's --queries default
PRIOR_REL = 1e-9               # prior at the actual lengths == metered Wh
TELEMETRY_REL = 1e-6           # telemetry's Wh == the responses' Wh
GOV_PER_TASK = 200             # make_stream(per_task=200): 1,000 queries
GOV_CAP = 0.6
GOV_GAIN, GOV_LAMBDA_MAX = 0.005, 0.75
GOV_ACCURACY = 0.9             # governed >= 0.9 x the ungoverned accuracy
GOV_KEEP = ("qwen2.5-0.5b", "qwen2.5-1.5b", "qwen2.5-7b", "llama-3.1-8b",
            "phi-4-mini-4b", "phi-4-14b", "gemma-3-12b", "qwen2.5-14b")
GOV_BATCH, GOV_ARMS = 10, 16
PLANNER_BUDGET_WH = 0.02       # about two queries of headroom
POWER_SAMPLE_MS = 250          # nvidia-smi's power.draw sampling period
# the resilience phase: the scenario lab's three runs at the bench's full
# sizes and the baselines' closed loop at its defaults; the chaos drill at
# per_task 60; disaggregation at full width (granite-3-8b and qwen2-moe
# on the serving weights), tests/test_disagg.py's six queries at
# max_batch 1 (exact) and its max_batch of 2, the disaggregation bench's
# MMPP workload with B = 2
# slots a role, its timescales scaled by the modeled decode tick (full
# width over the bench's smoke model), and the launcher at 12 queries
RES_FLASH_PER_TASK = 100
RES_FLOOD_PER_TASK = RES_CHURN_PER_TASK = RES_CHAOS_PER_TASK = 60
RES_CHURN_ARMS = (15, 16)      # pool churn: the pool before and after
DISAGG_ARCHS = ("granite-3-8b", MOE_ARCH)
DISAGG_QUERIES, DISAGG_SEED = 6, 3
DISAGG_BATCH = 2
DISAGG_C1_BATCHES = (1, DISAGG_BATCH)
DISAGG_USERS = 30              # the MMPP workload's users (both runs; cut
                               # to 30 by the script's time limit)
DISAGG_KILL_QUERIES = 8
DISAGG_LAUNCHER_QUERIES = 12
# the fleet phase: the pool-scale bench's smoke run (150 queries a shard,
# {1, 4} shards) in both featurize placements and the fleet chaos variant
# at its 80 queries, each against the JAX package's figures on the CPU
# (``benchmarks/bench_pool_scale.py --smoke``, ``bench_chaos.py``'s
# ``run_fleet_chaos(n=80)``); then a full-width fleet of two shards over
# the serving engines' h2o-danube-3-4b and qwen2-moe-a2.7b (the weights
# shared), shard 1 killed at 40% of the arrivals
POOL_SCALE_JAX = {
    "shards1": {"n_queries": 150, "completed": 150, "span_s": 32.026,
                "throughput_qps": 4.684, "total_wh": 4.992,
                "unanswered": 0, "killed": False,
                "stats": {"dispatched": 150, "redispatched": 0,
                          "completed": 150, "failed": 0, "failovers": 0,
                          "syncs": 0, "adopted_engines": 0}},
    "shards4": {"n_queries": 600, "completed": 600, "span_s": 29.318,
                "throughput_qps": 20.465, "total_wh": 16.72,
                "unanswered": 0, "killed": True,
                "stats": {"dispatched": 600, "redispatched": 59,
                          "completed": 600, "failed": 0, "failovers": 1,
                          "syncs": 90, "adopted_engines": 8}}}
FLEET_CHAOS_N = 80
FLEET_CHAOS_JAX = {"n_queries": 80, "completed": 80, "failed": 0,
                   "span_s": 7.42,
                   "stats": {"dispatched": 80, "redispatched": 9,
                             "completed": 80, "failed": 0, "failovers": 1,
                             "syncs": 23, "adopted_engines": 8}}
FLEET_ARCHS = ("h2o-danube-3-4b", MOE_ARCH)
FLEET_QUERIES = 32             # stream queries through the full-width fleet
FLEET_GAP_TICKS = 6            # mean arrival gap, in modeled decode ticks
FLEET_HEARTBEAT_TICKS = 10     # heartbeat timeout, in modeled decode ticks
FLEET_KILL_FRAC = 0.4          # shard 1 dies at this share of the arrivals
FLEET_SYNC_EVERY = 4
FLEET_PROBE = 10               # queries the saved and restored fleets route
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


T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """A line of the report, after the seconds since the script started."""
    print(f"{time.perf_counter() - T0:8.2f} [{phase}] {msg}", flush=True)


def phase_done(phase: str, t: float, extra: str = "") -> None:
    """The phase's line, on standard error as well: where a run is cut at
    its time limit, the end of standard error still shows how far it got."""
    msg = f"phase {time.perf_counter() - t:.2f} s{extra}"
    log(phase, msg)
    print(f"{time.perf_counter() - T0:8.2f} [{phase}] {msg}",
          file=sys.stderr, flush=True)


def cuda_ms(fn, n: int = 200, budget_s: float = 0.5) -> float:
    """Mean milliseconds per call of ``fn`` over back-to-back calls,
    between two CUDA events, after a warm-up (two calls, four where a call
    takes under 10 ms): ``n`` calls, or fewer (at least 3) where ``n``
    would take longer than ``budget_s``."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    probe = time.perf_counter() - t
    if probe < 0.01:              # a fast call: two more warm-up calls
        fn()
        fn()
    n = max(3, min(n, int(budget_s / max(probe, 1e-9))))
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


def device_normal(gen: torch.Generator, shape: tuple, dt) -> torch.Tensor:
    """N(0, 1) samples drawn on the card from ``gen``, a seeded generator
    there, then cast to ``dt``: drawn with numpy and copied over, the
    attention rows' caches (up to 2 x 268 M values) took ~10 s a row."""
    return torch.randn(shape, generator=gen, device=gen.device).to(dt)


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
    instruction slices; "full": the texts alone) at Q = 1, 2, 4, 16, 25,
    64 and 256 (512 rows; Q = 2 and 4 are the cache phase's admission
    batches), with a featureless row (" ") at index 1 of every batch of
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
    contexts at d = 12 (the served pool's M = 4, the batch path's M = 64,
    the paper pool's M = 32 and RouterBench's M = 16), the docstring's
    production shape (M = 64, d = 128, Q = 1024) and a ragged Q = 1000, an
    odd M = 37, d = 150 (two column passes), and an indefinite A^-1 whose
    quadratic forms clamp to 0."""
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
    rows, worst = [], 0.0
    cases = ([(t, 60, 4, False) for t in GATING_T]
             + [(GATING_T[-1], 60, 4, True)]
             + [(t, 8, 2, False) for t in GROK_GATING_T])
    for t, e, k, tied in cases:
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
        rows.append(dict(t=t, e=e, k=k, tied=tied, err=err, ms=ms,
                         device_ms=dev_ms,
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

    gen = torch.Generator(device=dev).manual_seed(9)
    rows, worst = [], 0.0
    for name, b, sq, sk, hq, hk, hd, win, causal, dt in FLASH_CASES:
        q, k, v = (device_normal(gen, shape, dt)
                   for shape in ((b, sq, hq, hd), (b, sk, hk, hd),
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


def start_sass():
    """cuobjdump -sass of the built library, started in the background
    (~14 s of host time on the card's machine) for ``scan_sass``; None
    where the tool cannot be started."""
    from repro_torch.kernels import build

    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    try:
        return subprocess.Popen([str(tool), "-sass", str(build.build())],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    except OSError as e:
        log("kernels", f"sass of the scan kernels could not be read ({e})")
        return None


def scan_sass(proc) -> None:
    """Whether the scan kernels' compiled code holds tensor-core
    instructions (HMMA for mma.sync, HGMMA for wgmma), from ``start_sass``'s
    cuobjdump -sass of the built library; a note where the toolkit's
    cuobjdump cannot read it."""
    if proc is None:
        return
    try:
        out, err = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        log("kernels", "sass of the scan kernels could not be read "
            "(cuobjdump ran over 300 s)")
        return
    if proc.returncode:
        log("kernels", f"sass of the scan kernels could not be read "
            f"(cuobjdump exited {proc.returncode}: {err.strip()[-200:]})")
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

    gen = torch.Generator(device=dev).manual_seed(37)
    rows, worst = [], 0.0
    for name, b, s, hq, hk, hd, clen, win, dt in DECODE_CASES:
        q, k, v = (device_normal(gen, shape, dt)
                   for shape in ((b, 1, hq, hd), (b, s, hk, hd),
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
# 4b. the paper's closed loop on the 16-model pool
# ---------------------------------------------------------------------------


def take_launches(what: str, featurize: int, linucb: int) -> dict:
    """The router kernels' launches since the last reset, held against
    the route calls just driven; resets the counts for the next part."""
    got = read_launches()
    if (got["featurize"], got["linucb"]) != (featurize, linucb):
        raise AssertionError(
            f"{what}: featurize/linucb launched {got['featurize']}/"
            f"{got['linucb']} times, expected {featurize}/{linucb}")
    reset_launches()
    return {"featurize": featurize, "linucb": linucb}


def paper_claims(res: dict) -> None:
    """Every assertion of tests/test_paper_claims.py, on these results."""
    from repro_torch.core.types import TaskType
    from repro_torch.data.profiles import ACCURACY, mean_energy_mwh

    gs, rnd = res["greenserv"], res["random"]
    gain = gs.mean_accuracy / rnd.mean_accuracy
    ratio = gs.total_energy_wh / rnd.total_energy_wh
    checks = [
        ("accuracy gain vs random > 1.10", gain > 1.10, gain),
        ("energy ratio vs random < 0.95", ratio < 0.95, ratio),
        ("best static more accurate", res["best"].mean_accuracy
         > gs.mean_accuracy, res["best"].mean_accuracy),
        ("best static > 3x the energy", res["best"].total_energy_wh
         > 3 * gs.total_energy_wh, res["best"].total_energy_wh),
        ("smallest static less energy", res["smallest"].total_energy_wh
         < gs.total_energy_wh, res["smallest"].total_energy_wh),
        ("largest static accuracy < 0.45",
         res["largest"].mean_accuracy < 0.45, res["largest"].mean_accuracy),
        ("regret < 1.25x non-contextual", gs.cumulative_regret
         < 1.25 * res["nonctx"].cumulative_regret,
         (gs.cumulative_regret, res["nonctx"].cumulative_regret)),
        ("decision ms < 25", gs.mean_decision_ms < PAPER_DECISION_MS,
         gs.mean_decision_ms)]
    curve = gs.regret_curve
    t = len(curve)
    first = curve[t // 4] / (t // 4)
    last = (curve[-1] - curve[3 * t // 4]) / (t - 3 * t // 4)
    checks.append(("regret sublinear", last < 0.6 * first, (first, last)))
    per_q = gs.total_energy_wh / len(gs.selection_trace)
    for m, accs in ACCURACY.items():
        e = np.mean([mean_energy_mwh(m, task) / 1e3 for task in TaskType])
        if e <= per_q * 1.05:
            checks.append((f"no static model beats GreenServ at its energy "
                           f"({m})", np.mean(accs) <= gs.mean_accuracy + 0.02,
                           np.mean(accs)))
    failed = [c for c in checks if not c[1]]
    for name, ok, val in checks:
        log("paper", f"  {'ok ' if ok else 'FAIL'} {name}: {val}")
    if failed:
        raise AssertionError(f"paper claims failed: {[c[0] for c in failed]}")


def paper_phase(dev) -> dict:
    """The paper's experiments through the port's entry points, every
    router on the card with ``featurize="auto"``: (a) the replay at T =
    2,500 with every assertion of tests/test_paper_claims.py; (b) device
    vs host featurize at T = 750; (c) the §6.2.4 addition; (d) the paced
    ``PoolServer`` drive over 16 ``SimEngine``s; (e) the RouterBench
    sweep at its --smoke size.  Returns the router kernels' launches."""
    from repro_torch.benchmarks.common import (drive_pool_stream,
                                               make_router, run_policy,
                                               stream)
    from repro_torch.benchmarks.routerbench import (ALGORITHMS, ROW_NAMES,
                                                    run_algorithm)
    from repro_torch.configs.pool import ADDITION_MODEL
    from repro_torch.data import OutcomeSimulator

    launches = {"featurize": 0, "linucb": 0}

    def tally(counts):
        for k in launches:
            launches[k] += counts[k]

    # (a) the replay at T = 2,500
    qs = stream(per_task=PAPER_PER_TASK)
    res = {}
    reset_launches()
    t = time.perf_counter()
    gs = make_router(lam=0.4, seed=0, device=dev)
    if not gs._device_featurize_active():
        raise AssertionError("featurize='auto' did not resolve to the "
                             "device path on the card")
    res["greenserv"] = run_policy(gs, qs, OutcomeSimulator(7), "greenserv")
    gs_s = time.perf_counter() - t
    res["random"] = run_policy(None, qs, OutcomeSimulator(7), "random",
                               random_seed=3)
    for name, model in (("largest", "yi-34b"), ("smallest", "qwen2.5-0.5b"),
                        ("best", "gemma-3-27b")):
        res[name] = run_policy(None, qs, OutcomeSimulator(7), name,
                               static_model=model)
    nonctx = make_router(lam=0.4, algorithm="eps_greedy",
                         features=(False, False, False), seed=0, device=dev)
    res["nonctx"] = run_policy(nonctx, qs, OutcomeSimulator(7), "nonctx")
    ctx = make_router(lam=0.4, algorithm="eps_greedy_ctx", seed=0,
                      device=dev)
    res["eps_ctx"] = run_policy(ctx, qs, OutcomeSimulator(7), "eps_ctx")
    tally(take_launches("(a) T = 2,500", gs.n_routed, gs.n_routed))
    for name, r in res.items():
        log("paper", f"(a) {name:9s} acc {r.mean_accuracy:.4f}  energy "
            f"{r.total_energy_wh:.4f} Wh  regret {r.cumulative_regret:.4f}"
            f"  decision {r.mean_decision_ms:.4f} ms/query")
    rnd = res["random"]
    g = res["greenserv"]
    log("paper", f"(a) GreenServ vs random: accuracy "
        f"{100 * (g.mean_accuracy / rnd.mean_accuracy - 1):+.2f}% (paper "
        f"+22%), energy {100 * (g.total_energy_wh / rnd.total_energy_wh - 1):+.2f}"
        f"% (paper -31%); decision {g.mean_decision_ms:.4f} ms/query on "
        f"the card (paper ~7 ms, Table 4), {gs_s:.2f} s wall for "
        f"{len(qs)} queries; features ms/query {g.feature_ms}")
    paper_claims(res)

    # (b) device == host featurize at T = 750
    qs = stream(per_task=PAPER_TWIN_PER_TASK)
    twins = {}
    for featurize in ("device", "host"):
        r = make_router(lam=0.4, seed=0, device=dev, featurize=featurize)
        if r._device_featurize_active() != (featurize == "device"):
            raise AssertionError(f"featurize={featurize} took the wrong path")
        twins[featurize] = run_policy(r, qs, OutcomeSimulator(7), featurize)
    dv, hs = twins["device"], twins["host"]
    if not np.array_equal(dv.selection_trace, hs.selection_trace):
        bad = np.flatnonzero(dv.selection_trace != hs.selection_trace)
        raise AssertionError(f"(b) device and host featurize differ at "
                             f"{bad[:8].tolist()}")
    if (dv.mean_accuracy, dv.total_energy_wh) != (hs.mean_accuracy,
                                                  hs.total_energy_wh):
        raise AssertionError("(b) equal traces, unequal outcomes")
    tally(take_launches("(b) T = 750", len(qs), 2 * len(qs)))
    log("paper", f"(b) T = {len(qs)}: device and host featurize traces "
        f"identical; acc {dv.mean_accuracy:.4f}, {dv.total_energy_wh:.4f} "
        f"Wh; decision {dv.mean_decision_ms:.4f} (device) / "
        f"{hs.mean_decision_ms:.4f} (host) ms/query")

    # (c) the §6.2.4 addition
    qs = stream(per_task=PAPER_PER_TASK)
    add = make_router(lam=0.4, seed=0, device=dev, exclude=[ADDITION_MODEL])
    r = run_policy(add, qs, OutcomeSimulator(7), "addition",
                   add_model_at=PAPER_ADD_AT, add_model_name=ADDITION_MODEL)
    arm = add.pool.index_of(ADDITION_MODEL)
    after = r.selection_trace[PAPER_ADD_AT:]
    pulls = int((after == arm).sum())
    if pulls == 0:
        raise AssertionError(f"(c) {ADDITION_MODEL} never pulled after it "
                             f"joined")
    tally(take_launches("(c) addition", len(qs), len(qs)))
    log("paper", f"(c) {ADDITION_MODEL} joined at query {PAPER_ADD_AT}: "
        f"{pulls} of the {len(after)} later pulls (first at query "
        f"{PAPER_ADD_AT + int(np.argmax(after == arm))}); acc "
        f"{r.mean_accuracy:.4f}, {r.total_energy_wh:.4f} Wh")

    # (d) PoolServer over 16 SimEngines
    qs = stream(per_task=PAPER_SERVE_PER_TASK, seed=1)
    t = time.perf_counter()
    sr = drive_pool_stream(qs, batch=PAPER_SERVE_BATCH, device=dev,
                           fit_classifier=True)
    wall = time.perf_counter() - t
    answered = len(sr.server.responses)
    if answered != len(qs) or set(sr.server.responses) != {q.uid
                                                            for q in qs}:
        raise AssertionError(f"(d) {answered} of {len(qs)} answered")
    batches = -(-len(qs) // PAPER_SERVE_BATCH)
    tally(take_launches("(d) drive_pool_stream", batches, batches))
    log("paper", f"(d) PoolServer over 16 SimEngines: {answered}/{len(qs)} "
        f"answered in {sr.n_steps} steps ({sr.step_ms:.4f} ms a step, "
        f"{wall:.2f} s wall); acc {sr.mean_accuracy:.4f}, "
        f"{sr.total_energy_wh:.4f} Wh; {batches} route_batch calls")

    # (e) RouterBench at the --smoke size (CTS: the JAX package's
    # "thompson" row; the stochastic policies launch no router kernel)
    for algorithm in ALGORITHMS:
        t = time.perf_counter()
        card = run_algorithm(algorithm, n_per_task=PAPER_RB_PER_TASK,
                             device=dev)
        routed = card["n_queries"] * len(card["trajectory"])
        if algorithm == "linucb":
            tally(take_launches("(e) RouterBench linucb", routed, routed))
        else:
            take_launches(f"(e) RouterBench {algorithm}", 0, 0)
        log("paper", f"(e) RouterBench {ROW_NAMES[algorithm]} ({algorithm}):"
            f" AIQ {card['aiq']:.4f}, peak {100 * card['peak_acc']:.2f}%, "
            f"average {100 * card['avg_acc']:.2f}% (paper 0.607 / 75.7% / "
            f"71.7%); {routed} routes in {time.perf_counter() - t:.2f} s")
    cts_rows(dev)
    cholesky_vs_sherman_morrison(dev)
    return launches


def cts_rows(dev) -> None:
    """(f) The ``ctx-thompson`` row: at T = 2,500 on the card, beside the
    JAX package's CPU numbers; at T = 150 on the card and on the port's
    CPU path side by side — identical arms and key (at the first query
    whose arms differ, if any, the card's top-two gap is printed, and a
    gap above ``CTS_TIE`` fails).  CTS runs the host featurize path and
    scores on the card: no router kernel launches."""
    from repro_torch.benchmarks.common import make_router, run_policy, stream
    from repro_torch.core.types import Feedback
    from repro_torch.data import OutcomeSimulator

    qs = stream(per_task=PAPER_PER_TASK)
    t = time.perf_counter()
    r = make_router(lam=0.4, algorithm="cts", seed=0, device=dev)
    if (r._device_featurize_active()
            or r.policy.state.A.device.type != torch.device(dev).type):
        raise AssertionError("CTS must take the host featurize path and "
                             "keep its posterior on the card")
    res = run_policy(r, qs, OutcomeSimulator(7), "ctx-thompson")
    wall = time.perf_counter() - t
    take_launches("(f) ctx-thompson T = 2,500", 0, 0)
    ja, jw, jr = CTS_JAX_T2500
    log("paper", f"(f) ctx-thompson T = {len(qs)} on the card: acc "
        f"{res.mean_accuracy:.6f}, {res.total_energy_wh:.6f} Wh, regret "
        f"{res.cumulative_regret:.6f}, decision {res.mean_decision_ms:.4f} "
        f"ms/query, {wall:.2f} s wall (the JAX package on a CPU: "
        f"{ja:.6f}, {jw:.6f} Wh, regret {jr:.6f})")

    qs = stream(per_task=CTS_TWIN_PER_TASK)
    where = (dev, "cpu")
    routers = {w: make_router(lam=0.4, algorithm="cts", seed=0, device=w)
               for w in where}
    sims = {w: OutcomeSimulator(7) for w in where}
    first = None
    for t, q in enumerate(qs):
        ds = {w: routers[w].route(q) for w in where}
        arms = {w: d.model_index for w, d in ds.items()}
        if first is None and arms[dev] != arms["cpu"]:
            top = np.sort(ds[dev].ucb_scores)[::-1]
            first = (t, arms, float(top[0] - top[1]))
        for w in where:
            acc, e, lat, _ = sims[w](q, routers[w].pool.names[arms[w]])
            routers[w].feedback(Feedback(query_uid=q.uid,
                                         model_index=arms[w], accuracy=acc,
                                         energy_wh=e, latency_ms=lat))
    keys = {w: routers[w].policy.state_dict()["key"] for w in where}
    if not np.array_equal(keys[dev], keys["cpu"]):
        raise AssertionError(f"(f) CTS keys differ: {keys}")
    take_launches("(f) ctx-thompson T = 150", 0, 0)
    if first is not None:
        t, arms, gap = first
        log("paper", f"(f) CTS T = {len(qs)}: arms first differ at query "
            f"{t} ({arms}), the card's top-two gap there {gap:.3g}")
        if gap > CTS_TIE:
            raise AssertionError(f"(f) CTS on the card and on the CPU "
                                 f"differ at query {t} with a top-two gap "
                                 f"of {gap:.3g} > {CTS_TIE}")
    else:
        log("paper", f"(f) CTS T = {len(qs)}: the card's and the CPU "
            f"path's arms identical at every query, keys equal "
            f"({keys['cpu'].tolist()})")


def cholesky_vs_sherman_morrison(dev) -> None:
    """(g) The §Perf comparison of benchmarks/bench_overhead.py: LinUCB's
    paper-faithful Cholesky mode against the maintained Sherman–Morrison
    inverses on one seeded posterior at the paper pool's M = 32, d = 12 —
    scores within 2e-4 and the same arms, and one decision's time in
    each mode on the card (``select_batch`` at Q = 1, ending in its
    device→host read)."""
    from repro_torch.core import bandits
    from repro_torch.core.types import RouterConfig

    cfg = RouterConfig(max_arms=CHOL_ARMS[0], seed=0)
    d = cfg.context_dim
    pols = {mode: bandits.BanditPolicy(
        dataclasses.replace(cfg, solve_mode=mode), n_arms=CHOL_ARMS[1],
        device=dev) for mode in bandits.SOLVE_MODES}
    rng = np.random.default_rng(4)

    def context(n):
        x = np.zeros((n, d), np.float32)
        x[np.arange(n), rng.integers(0, 5, n)] = 1.0
        x[np.arange(n), 5 + rng.integers(0, 3, n)] = 1.0
        x[np.arange(n), 8 + rng.integers(0, 3, n)] = 1.0
        x[:, -1] = 1.0
        return x

    for x in context(CHOL_UPDATES):
        arm, r = int(rng.integers(CHOL_ARMS[1])), float(rng.normal())
        for pol in pols.values():
            pol.update(arm, x, r)
    X = torch.from_numpy(context(64)).to(dev)
    st = pols["cholesky"].state
    sm = bandits.linucb_scores_batch(st, X, cfg.alpha_ucb)
    ch = bandits.linucb_scores_cholesky(st, X, cfg.alpha_ucb)
    err = float((sm - ch)[:, :CHOL_ARMS[1]].abs().max())
    if not err <= CHOL_TOL:
        raise AssertionError(f"(g) Cholesky vs Sherman–Morrison scores: "
                             f"max abs err {err} > {CHOL_TOL}")
    feas = np.ones((1, CHOL_ARMS[1]), bool)
    xs = context(CHOL_DECISIONS)
    ms, chosen = {}, {}
    for mode, pol in pols.items():
        pol.select_batch(xs[:1], feas)              # warm-up
        torch.cuda.synchronize()
        t = time.perf_counter()
        chosen[mode] = [int(pol.select_batch(x[None], feas)[0][0])
                        for x in xs]
        ms[mode] = (time.perf_counter() - t) * 1e3 / len(xs)
    if chosen["cholesky"] != chosen["sherman_morrison"]:
        raise AssertionError("(g) the two solve modes chose different arms")
    reset_launches()          # the comparison's launches are not a path's
    log("paper", f"(g) LinUCB at M = {CHOL_ARMS[0]} ({CHOL_ARMS[1]} live), "
        f"d = {d}, after {CHOL_UPDATES} updates: Cholesky vs "
        f"Sherman–Morrison scores max abs err {err:.3g} (tolerance "
        f"{CHOL_TOL}), the same arms over {len(xs)} decisions; one "
        f"decision on the card {ms['sherman_morrison']:.4f} ms "
        f"(Sherman–Morrison, the LinUCB kernel) against "
        f"{ms['cholesky']:.4f} ms (Cholesky, factor + solves in PyTorch), "
        f"{ms['cholesky'] / ms['sherman_morrison']:.2f}x")


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


def serving_engines(dev) -> dict:
    """The four full-width serving engines (bf16, ``use_pallas=True``,
    random weights from a seed, cut in depth: ``SERVE_CUTS``), at
    the launcher's ``max_batch``, ``max_len`` and prefill chunk."""
    from repro_torch.configs import for_mode, get_config
    from repro_torch.data import tokenizer as tok
    from repro_torch.serving.engine import ModelEngine

    engines = {}
    for i, arch in enumerate(SERVE_ARCHS):
        cfg = for_mode(get_config(arch, vocab_size=tok.VOCAB_SIZE,
                                  max_seq_len=SERVE_MAX_LEN, use_pallas=True,
                                  **SERVE_CUTS.get(arch, {})), "serve")
        full = get_config(arch).n_layers
        eng = engines[arch] = ModelEngine(
            arch, cfg, seed=i, max_batch=4, max_len=SERVE_MAX_LEN,
            detokenize=tok.decode, prefill_chunk=SERVE_CHUNK, device=dev)
        moe = (f", {cfg.n_experts} experts top-{cfg.top_k} of width "
               f"{cfg.moe_d_ff} + {cfg.n_shared_experts} shared"
               if cfg.layout == "moe" else "")
        n_params = sum(p.numel() for p in eng.params.parameters())
        cut = "no depth cut" if cfg.n_layers == full else "depth cut"
        log("serve", f"{arch}: {cfg.n_layers}/{full} layers ({cut}), "
            f"d_model {cfg.d_model}, d_ff {cfg.d_ff}{moe}, "
            f"{n_params / 1e9:.3f} B params in bf16 "
            f"({cfg.active_param_count() / 1e9:.2f} B active by the energy "
            f"model), prefill chunk {eng.prefill_chunk}")
    return engines


def serving_phase(dev) -> dict:
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.router import GreenServRouter
    from repro_torch.core.types import RouterConfig
    from repro_torch.data import stream as stream_lib
    from repro_torch.data import tokenizer as tok
    from repro_torch.serving.request import Request
    from repro_torch.serving.scheduler import PoolServer

    t0 = time.perf_counter()
    engines = serving_engines(dev)
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
    # at full width do real work.  Ten of them: the script's time limit
    decode_slice = [dataclasses.replace(q, uid=q.uid + 10_000,
                                        text=q.text.split("\n", 1)[0])
                    for q in stream_lib.make_stream(per_task=2, seed=5)]
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
# 5b. GreenCache on the serving phase's full-width engines
# ---------------------------------------------------------------------------


def serve_one(eng, prompt: list, uid: int) -> tuple:
    """One request through a one-slot engine: (its response, the logits
    of its first generated token as fp32 on the host)."""
    from repro_torch.core.types import Query
    from repro_torch.serving.request import Request

    rows, read = [], eng._read_next

    def recording(last_logits):
        rows.append(last_logits[0].float().cpu())
        return read(last_logits)

    eng._read_next = recording
    try:
        req = Request(query=Query(uid=uid, text="warm or cold"),
                      prompt_tokens=prompt,
                      max_new_tokens=CACHE_WARM_NEW)
        eng.submit(req)
        first, done = None, []
        while not done:
            done += eng.step()
            if first is None and req.generated:
                first = rows[-1]
    finally:
        del eng._read_next
    return done[0], first


def counted_routes(router) -> list:
    """Record the batch size of every ``route_batch`` call on ``router``."""
    calls, route = [], router.route_batch

    def counted(qs, *args, **kwargs):
        calls.append(len(qs))
        return route(qs, *args, **kwargs)

    router.route_batch = counted
    return calls


def cache_phase(dev, engines) -> dict:
    """GreenCache at full width (bf16, ``use_pallas=True``): (a) the
    admission probe through the featurize kernel against the host
    ``GreenCache.features``; (b) warm (a spliced 40-token preamble) vs
    cold generation on granite-3-8b and qwen2-moe-a2.7b, and rwkv6's
    layout gate; (c) the cache workload through ``PoolServer`` over
    granite, qwen2-moe and danube with the cache off and full.  Returns
    the launches of (b) and (c)."""
    from repro_torch.benchmarks import cache as cache_bench
    from repro_torch.cache import GreenCache, PrefixCache
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.router import GreenServRouter
    from repro_torch.core.types import RouterConfig
    from repro_torch.data import tokenizer as tok
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.scheduler import PoolServer

    queries, arrivals = cache_bench.make_workload(CACHE_QUERIES, seed=0)
    sub = {a: engines[a] for a in CACHE_ARCHS}

    def router():
        return GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05),
                               ModelPool([e.profile for e in sub.values()]),
                               device=dev)

    # (a) probe parity: one featurize launch a probe, labels and clusters
    # equal to the host path's, embeddings within 1e-5
    r = router()
    r.route_batch(queries[:8])              # live centroids to assign to
    cache = GreenCache(mode="full", kv_cache_blocks=CACHE_BLOCKS,
                       semantic_threshold=CACHE_THRESHOLD)
    cache.bind_context(r.context)
    for q in CACHE_PROBE_Q:
        texts = [x.text for x in queries[:q]]
        reset_launches()
        labels, clusters, embs = cache.features_batch(texts)
        n = read_launches()["featurize"]
        if n != 1:
            raise AssertionError(f"(a) the probe at Q = {q} launched "
                                 f"featurize {n} times, not once")
        host = [cache.features(t) for t in texts]
        err = float(np.abs(embs - np.stack([h[2] for h in host])).max())
        if (labels.tolist() != [h[0] for h in host]
                or clusters.tolist() != [h[1] for h in host]
                or not err <= FEATURIZE_TOL):
            raise AssertionError(f"(a) probe at Q = {q}: labels/clusters "
                                 f"differ from the host path or embedding "
                                 f"err {err} > {FEATURIZE_TOL}")
        log("cache", f"(a) probe Q = {q}: one featurize launch; labels, "
            f"clusters equal to the host features, embeddings max abs err "
            f"{err:.3g}")
    del r, cache
    reset_launches()

    # (b) warm vs cold in a one-slot engine on the serving weights
    # the preamble (41 tokens with BOS) shares 5 whole 8-token blocks
    pre = cache_bench.PREAMBLES[0]
    if len(tok.encode(pre)) // 8 * 8 != CACHE_PREAMBLE:
        raise AssertionError(f"the preamble is {len(tok.encode(pre))} "
                             f"tokens: not {CACHE_PREAMBLE} in whole blocks")
    other, prompt = (tok.encode(pre + tail) for tail in cache_bench.TAILS[:2])
    for arch in CACHE_WARM_ARCHS:
        src = engines[arch]
        eng = ModelEngine(arch, src.cfg, max_batch=1, max_len=SERVE_MAX_LEN,
                          params=src.params, prefill_chunk=SERVE_CHUNK,
                          device=dev)
        eng.set_prefix_cache(PrefixCache(max_blocks=CACHE_BLOCKS))
        serve_one(eng, other, 0)            # cold; its blocks captured
        warm, warm_logits = serve_one(eng, prompt, 1)
        if warm.prefix_reused != CACHE_PREAMBLE:
            raise AssertionError(f"(b) {arch}: spliced {warm.prefix_reused}"
                                 f" tokens, not the {CACHE_PREAMBLE}-token "
                                 f"preamble")
        eng.set_prefix_cache(None)
        cold, cold_logits = serve_one(eng, prompt, 2)
        gap = float((warm_logits - cold_logits).abs().max())
        if warm.tokens != cold.tokens or eng.nonfinite_ticks:
            raise AssertionError(f"(b) {arch}: warm {warm.tokens} != cold "
                                 f"{cold.tokens} (non-finite ticks "
                                 f"{eng.nonfinite_ticks})")
        log("cache", f"(b) {arch}: warm (spliced {warm.prefix_reused} "
            f"tokens of {len(prompt)}) and cold generations identical "
            f"{warm.tokens}; first token's logits max abs gap {gap:.4g} "
            f"(range {float(cold_logits.abs().max()):.4g}); "
            f"{eng.tick_counts} ticks, avoided "
            f"{eng.cumulative_joules_avoided():.4f} J")
        del eng
    rwkv = engines[RWKV_ARCH]
    rwkv.set_prefix_cache(PrefixCache(max_blocks=CACHE_BLOCKS))
    if rwkv.prefix_cache is not None:
        raise AssertionError(f"{RWKV_ARCH} took a prefix cache")
    log("cache", f"(b) {RWKV_ARCH}: set_prefix_cache leaves it None "
        f"(recurrent state takes no splice)")
    launches = read_launches()

    # (c) the cache workload through PoolServer, off then full
    cards = {}
    for mode in ("off", "full"):
        r = router()
        calls = counted_routes(r)
        cache = GreenCache(mode=mode, kv_cache_blocks=CACHE_BLOCKS,
                           semantic_threshold=CACHE_THRESHOLD)
        server = PoolServer(r, sub, tokenizer=tok.encode,
                            accuracy_fn=exact_match_accuracy,
                            prefill_chunk=SERVE_CHUNK, cache=cache)
        reset_launches()
        t = time.perf_counter()
        card = cache_bench.drive(server, queries, arrivals)
        torch.cuda.synchronize()
        card["wall_s"] = time.perf_counter() - t
        got = read_launches()
        routed = sum(n > 0 for n in calls)
        if card["completed"] != len(queries):
            raise AssertionError(f"(c) {mode}: {card['completed']}/"
                                 f"{len(queries)} answered")
        # off: route_batch featurizes ("both") and scores each batch;
        # full: the probe is the batch's one featurize launch, and the
        # decision takes its embeddings and labels (mode "none")
        want = {"featurize": (routed if mode == "off"
                              else card["admission_batches"]),
                "linucb": routed}
        if {k: got[k] for k in want} != want:
            raise AssertionError(f"(c) {mode}: launches {got}, expected "
                                 f"{want} ({card['admission_batches']} "
                                 f"admission batches, {routed} routed)")
        for k in ("featurize", "linucb", "moe_gating"):
            launches[k] += got[k]
        cards[mode] = card
        log("cache", f"(c) {mode}: {card['completed']}/{len(queries)} "
            f"answered in {card['steps']} steps ({card['wall_s']:.2f} s), "
            f"{card['admission_batches']} admission batches, {routed} "
            f"routed; semantic hits {card['semantic_hits']}, prefix hits "
            f"{card['prefix_hits']} ({card['prefix_tokens_reused']} prompt "
            f"tokens reused), metered {card['joules']:.4f} J, avoided "
            f"{card['avoided_joules']:.4f} J, mean TTFT "
            f"{card['ttft_steps_mean']:.3f} steps; launches "
            f"{ {k: got[k] for k in ('featurize', 'linucb', 'moe_gating')} }")
        for e in sub.values():
            e.set_prefix_cache(None)
        del server, cache, r
    off, full = cards["off"], cards["full"]
    if not (full["semantic_hits"] > 0 and full["prefix_hits"] > 0
            and full["joules"] < off["joules"]):
        raise AssertionError(f"(c) full mode: {full['semantic_hits']} "
                             f"semantic hits, {full['prefix_hits']} prefix "
                             f"hits, {full['joules']} J against off's "
                             f"{off['joules']} J")
    log("cache", f"(c) full vs off: metered joules x"
        f"{full['joules'] / off['joules']:.4f} "
        f"({100 * (1 - full['joules'] / off['joules']):.2f}% less; the JAX "
        f"package's --smoke claims >= 30% on its smoke engines, not "
        f"asserted at full width), mean TTFT {full['ttft_steps_mean']:.3f}"
        f" vs {off['ttft_steps_mean']:.3f} steps")
    gc.collect()
    return launches, off["joules"]


# ---------------------------------------------------------------------------
# 5c. the energy-governed serving path: the launcher's default run at full
#     width, the governor's cap, the planner, the cache workload governed
# ---------------------------------------------------------------------------


def set_launches(counts: dict) -> None:
    """Every wrapper's launch count back to ``counts``."""
    for name, mod in _ops_modules().items():
        mod.launches = counts[name]


@contextlib.contextmanager
def host_twin(router_cls, twin):
    """While active, every ``route_batch`` and ``feedback_batch`` of any
    other ``router_cls`` is replayed on ``twin`` (a host-featurize router
    on the same card) with the same arguments — the same queries, cost
    matrix and prefix discounts, the same feedback.  The twin's launches
    are comparisons: the counts are put back after each replay.  Yields
    the list of (arms, twin's arms) per routed batch."""
    route, feedback = router_cls.route_batch, router_cls.feedback_batch
    batches = []

    def routing(self, queries, *args, **kwargs):
        decisions = route(self, queries, *args, **kwargs)
        if self is not twin and queries:
            saved = read_launches()
            mirror = route(twin, queries, *args, **kwargs)
            set_launches(saved)
            batches.append(([d.model_index for d in decisions],
                            [d.model_index for d in mirror]))
        return decisions

    def feeding(self, fbs, *args, **kwargs):
        out = feedback(self, fbs, *args, **kwargs)
        if self is not twin:
            saved = read_launches()
            feedback(twin, fbs, *args, **kwargs)
            set_launches(saved)
        return out

    router_cls.route_batch, router_cls.feedback_batch = routing, feeding
    try:
        yield batches
    finally:
        router_cls.route_batch, router_cls.feedback_batch = route, feedback


@contextlib.contextmanager
def power_draw():
    """The card's power draw in W, read by ``nvidia-smi --query-gpu=
    power.draw`` every ``POWER_SAMPLE_MS`` from a thread while the block
    runs (each read is a process that ends before the next starts).
    Yields the list the samples go into."""
    import threading

    watts, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=power.draw",
                     "--format=csv,noheader,nounits"], capture_output=True,
                    text=True, timeout=10).stdout.split()
            except (OSError, subprocess.SubprocessError):
                return                    # no reading: "not measured"
            if out:
                watts.append(float(out[0]))
            stop.wait(POWER_SAMPLE_MS / 1e3)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield watts
    finally:
        stop.set()
        thread.join(timeout=20)


def energy_phase(dev, engines, cache_off_joules: float) -> dict:
    """The energy-governed serving path on the card: (a) the launcher's
    default configuration (``launch.serve.serve``) over the serving
    phase's full-width granite-3-8b, rwkv6-1.6b and qwen2-moe-a2.7b —
    every query answered, every forecast reconciled, the prior at the
    actual lengths equal to the metered Wh of each cold response, the
    telemetry's Wh equal to the responses', one featurize and one LinUCB
    launch per routed batch, and a host-featurize twin router fed the
    same queries, cost matrices, discounts and feedback picking the same
    arms; the modeled watts beside the card's own power draw; (b) the
    governor at the JAX package's acceptance (60% cap held, accuracy >=
    0.9x, λ above 0.4, its Wh == the served Wh) on ``SimEngine``s of the
    paper pool with the router on the card, and the admission planner at
    a tight budget; (c) the cache workload (full mode) governed at the
    uncached run's spend, its avoided Wh credited to the governor.
    Returns the router kernels' and the gating kernel's launches."""
    from repro_torch.benchmarks import cache as cache_bench
    from repro_torch.benchmarks.common import drive_pool_stream
    from repro_torch.cache import GreenCache
    from repro_torch.configs.pool import PAPER_POOL
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.router import GreenServRouter
    from repro_torch.core.types import ModelProfile, Query, RouterConfig
    from repro_torch.costmodel import EnergyCostModel
    from repro_torch.data import tokenizer as tok
    from repro_torch.data.stream import make_stream
    from repro_torch.launch import serve as launcher
    from repro_torch.serving.engine import SimEngine
    from repro_torch.serving.scheduler import PoolServer
    from repro_torch.telemetry import EnergyBudgetGovernor, Telemetry

    launches = {"featurize": 0, "linucb": 0, "moe_gating": 0}

    def tally(got):
        for k in launches:
            launches[k] += got.get(k, 0)

    # (a) the launcher's default configuration at full width
    args = launcher.build_parser().parse_args(
        ["--queries", str(ENERGY_QUERIES), "--device", str(dev)])
    served = {a: engines[a] for a in args.pool}
    for name, e in served.items():
        got = (e.max_batch, e.max_len, e.cfg.use_pallas, e.cfg.param_dtype,
               e.prefill_chunk)
        want = (4, SERVE_MAX_LEN, True, "bfloat16",
                1 if name == RWKV_ARCH else args.prefill_chunk)
        if got != want:
            raise AssertionError(f"(a) {name}: {got}, not the launcher's "
                                 f"{want}")
    moe_eng = served[MOE_ARCH]
    moe_ticks0 = sum(moe_eng.tick_counts.values())
    twin = GreenServRouter(
        RouterConfig(lam=args.lam, energy_scale_wh=0.05, featurize="host"),
        ModelPool([e.profile for e in served.values()]), device=dev)
    reset_launches()
    t = time.perf_counter()
    with host_twin(GreenServRouter, twin) as batches, power_draw() as watts:
        run = launcher.serve(args, served,
                             ModelPool([e.profile for e in served.values()]))
        torch.cuda.synchronize()
    t_a = time.perf_counter() - t
    got = read_launches()
    server, cm, tel = run["server"], run["cost_model"], run["telemetry"]
    router, queries = run["router"], run["queries"]
    if not router._device_featurize_active():
        raise AssertionError("(a) the launcher's router is not on the "
                             "device featurize path")
    resp = list(server.responses.values())
    if len(resp) != len(queries) or len(queries) != ENERGY_QUERIES:
        raise AssertionError(f"(a) {len(resp)}/{len(queries)} answered")
    routed = sum(len(a) for a, _ in batches)
    if not (cm.n_predicted == cm.n_reconciled == routed == len(queries)
            and cm.inflight_predicted == 0):
        raise AssertionError(f"(a) {cm.n_reconciled}/{cm.n_predicted} "
                             f"forecasts reconciled, {routed} queries "
                             f"routed of {len(queries)}")
    cold, worst = 0, 0.0
    for r in resp:
        if r.prefix_reused:
            continue
        a_pre, a_dec = cm.engines[r.model_name].analytic_split_wh(
            r.input_tokens, r.output_tokens)
        worst = max(worst, abs(a_pre + a_dec - r.energy_wh) / r.energy_wh)
        cold += 1
    if not cold or worst > PRIOR_REL:
        raise AssertionError(f"(a) prior vs metered Wh: {worst:.3g} "
                             f"relative over {cold} cold responses")
    served_wh = sum(r.energy_wh for r in resp)
    tel_wh = sum(m.value for m in tel.registry
                 if m.name == "greenserv_energy_mwh_total") / 1e3
    if abs(tel_wh - served_wh) > TELEMETRY_REL * served_wh:
        raise AssertionError(f"(a) telemetry {tel_wh} Wh, responses "
                             f"{served_wh} Wh")
    want = {"featurize": len(batches), "linucb": len(batches),
            "moe_gating": moe_eng.cfg.n_layers
            * (sum(moe_eng.tick_counts.values()) - moe_ticks0)}
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"(a) launches {got}, expected {want} over "
                             f"{len(batches)} routed batches")
    differ = [i for i, (a, b) in enumerate(batches) if a != b]
    if differ:
        raise AssertionError(f"(a) the device router and its host twin "
                             f"picked different arms in batches "
                             f"{differ[:8]}: {batches[differ[0]]}")
    for name, e in served.items():
        if e.nonfinite_ticks:
            raise AssertionError(f"(a) {name}: {e.nonfinite_ticks} ticks "
                                 f"with non-finite logits")
        e.set_prefix_cache(None)
    tally(got)
    mae = cm.stats()["mae_ratio"]
    log("energy", f"(a) launcher defaults at full width: "
        f"{len(resp)}/{len(queries)} answered in {t_a:.2f} s "
        f"({server._step_idx} steps, {t_a / server._step_idx * 1e3:.3f} ms "
        f"each); {cm.n_reconciled}/{cm.n_predicted} forecasts reconciled, "
        f"MAE {mae:.4f} of metered Wh; prior == metered on {cold} cold "
        f"responses (worst {worst:.3g} relative); telemetry {tel_wh:.9f} Wh "
        f"== responses {served_wh:.9f} Wh; {len(batches)} routed batches, "
        f"device == host-twin arms in all; launches {want}; arms "
        f"{dict(zip(router.pool.names, map(int, router.selection_counts())))}"
        f"; prefix hits {sum(r.prefix_reused > 0 for r in resp)}")
    card_w = (f"mean {np.mean(watts):.2f} W, max {np.max(watts):.2f} W over "
              f"{len(watts)} samples" if watts else "not measured")
    log("energy", f"(a) power: modeled by the H100 constants of "
        f"core/energy.py, pool mean {tel.power.avg_watts():.2f} W and peak "
        f"{tel.power.peak_watts():.2f} W over the run's wall clock; the "
        f"card's own power.draw (nvidia-smi, every {POWER_SAMPLE_MS} ms) "
        f"{card_w} — different quantities, nothing gated on them")
    del run, server, twin, router

    # (b) the governor at the reference's acceptance; the planner
    exclude = [row[0] for row in PAPER_POOL if row[0] not in GOV_KEEP]
    kw = dict(seed=0, batch=GOV_BATCH, exclude=exclude, max_arms=GOV_ARMS,
              fit_classifier=True, device=dev)
    queries = make_stream(per_task=GOV_PER_TASK, seed=0)
    reset_launches()
    t = time.perf_counter()
    free = drive_pool_stream(queries, Telemetry(), **kw)
    budget = GOV_CAP * free.total_energy_wh
    governor = EnergyBudgetGovernor(budget, horizon_queries=len(queries),
                                    gain=GOV_GAIN, lambda_max=GOV_LAMBDA_MAX)
    run = drive_pool_stream(queries, Telemetry(governor=governor), **kw)
    t_b = time.perf_counter() - t
    if not run.server.router._device_featurize_active():
        raise AssertionError("(b) the router is not on the device path")
    calls = 2 * -(-len(queries) // GOV_BATCH)
    tally(take_launches("(b) the governed drive", calls, calls))
    tel = run.server.telemetry
    peak = max((lam for _, lam in governor.lambda_history), default=0.0)
    lat = tel.registry.find("greenserv_latency_ms")
    checks = [
        ("every query answered", len(free.server.responses)
         == len(run.server.responses) == len(queries)),
        ("the cap held", run.total_energy_wh <= budget),
        (f"accuracy >= {GOV_ACCURACY}x the ungoverned",
         run.mean_accuracy >= GOV_ACCURACY * free.mean_accuracy),
        ("λ peaked above 0.4", peak > 0.4),
        ("governor Wh == served Wh", abs(governor.cumulative_wh
                                         - run.total_energy_wh)
         <= 1e-6 * run.total_energy_wh),
        ("telemetry saw every admission and completion",
         tel.registry.find("greenserv_admitted_total").value == len(queries)
         and lat is not None and lat.count == len(queries)),
        ("power trace nonzero", tel.power.total_wh() > 0)]
    failed = [name for name, ok in checks if not ok]
    if failed:
        raise AssertionError(f"(b) governor: {failed}")
    log("energy", f"(b) governor at T = {len(queries)} ({len(GOV_KEEP)} "
        f"paper-pool models, router on the card): ungoverned "
        f"{free.total_energy_wh:.6f} Wh / accuracy "
        f"{free.mean_accuracy:.4f}; cap {budget:.6f} Wh ({GOV_CAP:.0%}); "
        f"governed {run.total_energy_wh:.6f} Wh "
        f"({run.total_energy_wh / budget:.4f} of the cap) / accuracy "
        f"{run.mean_accuracy:.4f} "
        f"({run.mean_accuracy / free.mean_accuracy:.4f}x); λ peak "
        f"{peak:.4f}, final {governor.current_lambda:.4f}, "
        f"{len(governor.lambda_history)} changes; {t_b:.2f} s for both "
        f"runs, {calls} routing calls")
    profiles = [ModelProfile(name=f"sim{i}", family="s", params_b=i + 1.0)
                for i in range(2)]
    prouter = GreenServRouter(RouterConfig(lam=0.4, max_arms=8),
                              ModelPool(profiles), device=dev)
    sims = {p.name: SimEngine(p, lambda q, m: (0.9, 0.01, 5.0, 4))
            for p in profiles}
    pgov = EnergyBudgetGovernor(PLANNER_BUDGET_WH, horizon_queries=12)
    pcm = EnergyCostModel()
    for p in profiles:
        m = pcm.register_engine(p.name)
        for _ in range(30):
            m.observe(n_prompt=8, n_out=4, max_new_tokens=4, reused=0,
                      migrated=False, occupancy=0.0, measured_wh=0.01)
    planner = PoolServer(prouter, sims, telemetry=Telemetry(governor=pgov),
                         cost_model=pcm, admission_planner=True)
    calls = counted_routes(prouter)
    planner.enqueue_many([Query(uid=i, text=f"plan query {i}",
                                max_new_tokens=4) for i in range(12)])
    reset_launches()
    planner.run_until_drained()
    tally(take_launches("(b) the planner", len(calls), len(calls)))
    if not (len(planner.responses) == 12 and planner.stats["deferred"] > 0
            and pcm.n_reconciled == 12):
        raise AssertionError(f"(b) planner: {len(planner.responses)}/12 "
                             f"answered, {planner.stats['deferred']} "
                             f"deferred, {pcm.n_reconciled} reconciled")
    log("energy", f"(b) planner at {PLANNER_BUDGET_WH} Wh: 12/12 answered in "
        f"{planner._step_idx} steps, {planner.stats['deferred']} "
        f"deferrals, {len(calls)} routing calls")
    del free, run, planner

    # (c) the cache workload with the governor in the loop
    sub = {a: engines[a] for a in CACHE_ARCHS}
    queries, arrivals = cache_bench.make_workload(CACHE_QUERIES, seed=0)
    clock = {"t": 0.0}
    tel = cache_bench.governed_telemetry(cache_off_joules / 3600.0, arrivals,
                                         clock)
    crouter = GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05),
                              ModelPool([e.profile for e in sub.values()]),
                              device=dev)
    calls = counted_routes(crouter)
    cache = GreenCache(mode="full", kv_cache_blocks=CACHE_BLOCKS,
                       semantic_threshold=CACHE_THRESHOLD,
                       clock=lambda: clock["t"])
    server = PoolServer(crouter, sub, tokenizer=tok.encode,
                        accuracy_fn=exact_match_accuracy,
                        prefill_chunk=SERVE_CHUNK, cache=cache,
                        telemetry=tel)
    # the engines' avoided-joule meters carry the earlier phases' hits;
    # the hub's first step books them whole (the JAX package's hub does
    # the same), so this run's own credit is the credit less this carry
    carried_j = sum(e.cumulative_joules_avoided() for e in sub.values())
    reset_launches()
    t = time.perf_counter()
    card = cache_bench.drive(server, queries, arrivals, clock=clock)
    torch.cuda.synchronize()
    t_c = time.perf_counter() - t
    got = read_launches()
    routed = sum(n > 0 for n in calls)
    want = {"featurize": card["admission_batches"], "linucb": routed}
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"(c) launches {got}, expected {want}")
    tally(got)
    g = card["governor"]
    avoided = {k: tel.registry.find("greenserv_energy_joules_avoided_total",
                                    {"kind": k}).value
               for k in ("prefix", "semantic")}
    credited_j = g["avoided_prefix_wh"] * 3600.0
    own_j = card["avoided_joules"]
    if not (card["completed"] == len(queries)
            and own_j > 0 and g["avoided_semantic_wh"] > 0
            and abs(credited_j - (carried_j + own_j))
            <= TELEMETRY_REL * (carried_j + own_j)
            and abs(avoided["prefix"] - credited_j)
            <= TELEMETRY_REL * credited_j
            and abs(avoided["semantic"] - g["avoided_semantic_wh"] * 3600.0)
            <= TELEMETRY_REL * avoided["semantic"]
            and abs(g["cumulative_wh"] - card["response_wh"])
            <= TELEMETRY_REL * card["response_wh"]):
        raise AssertionError(f"(c) {card['completed']}/{len(queries)} "
                             f"answered; governor {g}; avoided {avoided} J "
                             f"in the export, {own_j} J this run, "
                             f"{carried_j} J carried")
    for e in sub.values():
        e.set_prefix_cache(None)
    log("energy", f"(c) cache workload, full mode, governed at the uncached "
        f"run's {cache_off_joules / 3600.0:.6f} Wh: "
        f"{card['completed']}/{len(queries)} answered in {card['steps']} "
        f"steps ({t_c:.2f} s); spent {g['cumulative_wh']:.6f} Wh; avoided "
        f"credited to the governor: prefix {own_j:.4f} J this run "
        f"({card['prefix_hits']} hits) + {carried_j:.4f} J carried by the "
        f"engines' meters = {g['avoided_prefix_wh']:.6f} Wh, semantic "
        f"{g['avoided_semantic_wh']:.6f} Wh ({card['semantic_hits']} hits); "
        f"the export {avoided['prefix']:.4f} / {avoided['semantic']:.4f} J; "
        f"final λ "
        f"{g['lambda']:.4f} after {g['lambda_changes']} changes, pressure "
        f"{g['pressure']:.4f}; launches {want}")
    del server, cache, crouter
    gc.collect()
    return launches


# ---------------------------------------------------------------------------
# 5d. the serving path under faults, bursts and churn: the scenario lab,
#     the chaos drill and disaggregated prefill/decode
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def routed(router_cls, mirror: bool = False):
    """While active, record every routing call of a device-featurize
    ``router_cls`` (and every device cache probe): per call, its arms, the
    pool's size and whether it featurized (no embeddings forwarded from a
    probe).  With ``mirror``, each such router also gets a host-featurize
    twin at its first call — a copy of it then, on the same card, with
    featurize "host" — that replays its every ``route_batch`` and
    ``feedback_batch`` with the same arguments and the same breaker mask,
    and joins every model its pool gains; the twin's arms are recorded
    beside the router's, and its launches, being comparisons, are put
    back.  Yields ``{"batches": [(arms, twin arms or None, pool size,
    featurized)], "probes": n}``."""
    import threading

    from repro_torch.core.context import ContextGenerator

    route, feedback = router_cls.route_batch, router_cls.feedback_batch
    probe = ContextGenerator.probe_batch
    twins, twin_ids = {}, set()
    ledger = {"batches": [], "probes": 0}

    def twin_of(router):
        pair = twins.get(id(router))
        if pair is None:
            # the breaker mask's provider is the server's bound method:
            # the copy must not take the server along
            health, router._arm_health = router._arm_health, None
            try:
                twin = copy.deepcopy(
                    router, {id(router.pool._lock): threading.RLock()})
            finally:
                router._arm_health = health
            twin.config.featurize = "host"
            pair = twins[id(router)] = (router, twin)
            twin_ids.add(id(twin))
        twin = pair[1]
        for i in range(len(twin.pool), len(router.pool)):
            twin.pool.add(router.pool[i])
        twin._arm_health = router._arm_health
        if twin.config.lam != router.config.lam:
            twin.set_lambda(router.config.lam)
        return twin

    def routing(self, queries, *args, **kwargs):
        if (not queries or id(self) in twin_ids
                or not self._device_featurize_active()):
            return route(self, queries, *args, **kwargs)
        twin = twin_of(self) if mirror else None
        decisions = route(self, queries, *args, **kwargs)
        mirrored = None
        if twin is not None:
            saved = read_launches()
            mirrored = [d.model_index
                        for d in route(twin, queries, *args, **kwargs)]
            set_launches(saved)
        ledger["batches"].append(
            ([d.model_index for d in decisions], mirrored, len(self.pool),
             kwargs.get("embeddings") is None))
        return decisions

    def feeding(self, fbs, *args, **kwargs):
        out = feedback(self, fbs, *args, **kwargs)
        pair = twins.get(id(self))
        if pair is not None and pair[0] is self:
            saved = read_launches()
            feedback(pair[1], fbs, *args, **kwargs)
            set_launches(saved)
        return out

    def probing(self, texts):
        if texts and self.device_active:
            ledger["probes"] += 1
        return probe(self, texts)

    router_cls.route_batch, router_cls.feedback_batch = routing, feeding
    ContextGenerator.probe_batch = probing
    try:
        yield ledger
    finally:
        router_cls.route_batch, router_cls.feedback_batch = route, feedback
        ContextGenerator.probe_batch = probe


def ledger_launches(what: str, ledger: dict, moe_ticks: int = 0,
                    moe_layers: int = 0) -> dict:
    """The router kernels' launches since the last reset held against the
    ledger's routing calls (one LinUCB launch each; one featurize launch
    each that featurized, and one per device cache probe), and the gating
    kernel's against the MoE engines' ticks; resets the counts."""
    got = read_launches()
    want = {"featurize": ledger["probes"] + sum(b[3] for b in
                                                ledger["batches"]),
            "linucb": len(ledger["batches"]),
            "moe_gating": moe_layers * moe_ticks}
    if {k: got[k] for k in want} != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")
    if not want["linucb"]:
        raise AssertionError(f"{what}: no routing call on the device path")
    reset_launches()
    return want


def twin_check(what: str, ledger: dict) -> None:
    """The device router and its host twin picked the same arms in every
    routed batch."""
    differ = [i for i, b in enumerate(ledger["batches"]) if b[0] != b[1]]
    if differ:
        raise AssertionError(f"{what}: the device router and its host twin "
                             f"picked different arms in batches "
                             f"{differ[:8]}: {ledger['batches'][differ[0]]}")


def scenario_part(dev, tally) -> None:
    """(a) ``benchmarks/scenarios.py``'s three runs with their checks (the
    pool churn with a host twin, equal arms in every batch before and after
    the pool grows) and the baselines' closed loop at its defaults."""
    from repro_torch.benchmarks import baselines
    from repro_torch.benchmarks import scenarios as lab
    from repro_torch.core.router import GreenServRouter

    runs = (("flash crowd", lab.run_flash_crowd, RES_FLASH_PER_TASK, False),
            ("duplicate flood", lab.run_duplicate_flood, RES_FLOOD_PER_TASK,
             False),
            ("pool churn", lab.run_pool_churn, RES_CHURN_PER_TASK, True))
    for name, run, per_task, mirror in runs:
        reset_launches()
        t = time.perf_counter()
        with routed(GreenServRouter, mirror=mirror) as ledger:
            res, checks = run(per_task=per_task, device=dev)
        secs = time.perf_counter() - t
        tally(ledger_launches(f"(a) {name}", ledger))
        twin = ""
        if mirror:
            twin_check(f"(a) {name}", ledger)
            sizes = sorted({b[2] for b in ledger["batches"]})
            if sizes != list(RES_CHURN_ARMS):
                raise AssertionError(f"(a) {name}: routed at pool sizes "
                                     f"{sizes}, not {RES_CHURN_ARMS}")
            after = sum(b[2] == RES_CHURN_ARMS[1] for b in ledger["batches"])
            twin = (f"; device == host-twin arms in all "
                    f"{len(ledger['batches'])} batches ({after} after the "
                    f"pool grew to {RES_CHURN_ARMS[1]} arms)")
        s = res.stats
        log("resilience", f"(a) {name} (per_task {per_task}): "
            f"{res.completed}/{res.n_queries} answered, {res.failed} "
            f"failed, accuracy {res.mean_accuracy:.4f}, "
            f"{res.total_energy_wh:.6f} Wh, span {res.span_s:.3f} "
            f"modeled s, {res.server._step_idx} steps in {secs:.2f} s; "
            f"cache hits {s['cache_hits']}, restarts {s['restarts']}, "
            f"deferred {s['deferred']}; {len(ledger['batches'])} routed "
            f"batches, {ledger['probes']} probes; the bench's "
            f"{len(checks)} checks held{twin}")
    reset_launches()
    t = time.perf_counter()
    with routed(GreenServRouter) as ledger:
        closed = baselines.run_closed_loop(device=dev)
    secs = time.perf_counter() - t
    tally(ledger_launches("(a) baselines' closed loop", ledger))
    gs, rnd = closed["greenserv"], closed["random"]
    checks = [(gs["completed"] == gs["n_queries"], "GreenServ answered all"),
              (gs["mean_accuracy"] >= rnd["mean_accuracy"] - 1e-9,
               "GreenServ accuracy >= random"),
              (gs["total_energy_wh"] < rnd["total_energy_wh"],
               "GreenServ Wh < random")]
    failed = [m for ok, m in checks if not ok]
    if failed:
        raise AssertionError(f"(a) baselines' closed loop: {failed}: {gs} "
                             f"vs {rnd}")
    log("resilience", "(a) baselines' closed loop (steady, per_task 200, "
        "governed at 0.8x the random spend, planner on): " + "; ".join(
            f"{p} {r['completed']}/{r['n_queries']} answered, accuracy "
            f"{r['mean_accuracy']:.4f}, {r['total_energy_wh']:.6f} Wh, "
            f"cache hits {r['stats']['cache_hits']}, deferred "
            f"{r['stats']['deferred']}" for p, r in closed.items())
        + f"; {len(ledger['batches'])} routed batches in {secs:.2f} s")


def chaos_part(dev, tally) -> None:
    """(b) ``benchmarks/chaos.py``'s ``main`` (its seven invariants) with a
    host twin of every run's router: equal arms in every batch while the
    breakers open and close."""
    from repro_torch.benchmarks import chaos
    from repro_torch.core.router import GreenServRouter

    reset_launches()
    t = time.perf_counter()
    with routed(GreenServRouter, mirror=True) as ledger:
        lines = chaos.main(per_task=RES_CHAOS_PER_TASK, fleet=False,
                           artifact=None, device=dev)
    secs = time.perf_counter() - t
    tally(ledger_launches("(b) chaos", ledger))
    twin_check("(b) chaos", ledger)
    log("resilience", f"(b) chaos drill (per_task {RES_CHAOS_PER_TASK}, "
        f"calibration + reliability + baseline runs) in {secs:.2f} s, the "
        f"seven invariants held; device == host-twin arms in all "
        f"{len(ledger['batches'])} batches: " + " | ".join(lines))


def disagg_queries(n: int, seed: int = 0, max_new=(2, 6)) -> list:
    """``tests/test_disagg.py``'s ``_queries``."""
    from repro_torch.core.types import Query

    rng = np.random.default_rng(seed)
    return [Query(uid=i,
                  text=f"probe {i} " + "ctx " * int(rng.integers(1, 7)),
                  max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def record_tokens(eng, seen: dict) -> None:
    """Record, per request uid, every generated token of ``eng`` with the
    top-two logit gap and the top logit of the row that produced it, the
    kind of tick ("chunk" or "decode") and the live rows it held."""
    read, advance = eng._read_next, eng._advance_slots
    chunk, decode = eng._chunk_tick, eng._decode_tick
    last = {}

    def reading(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        last["top"] = top.cpu().numpy()
        return read(logits)

    def ticking(kind, tick):
        def run():
            last["kind"] = kind
            return tick()
        return run

    def advancing(next_tok, fed_prompt):
        before = [(r, len(r.generated)) if r is not None else None
                  for r in eng.slots]
        live = sum(b is not None for b in before)
        out = advance(next_tok, fed_prompt)
        for i, b in enumerate(before):
            if b is not None and len(b[0].generated) > b[1]:
                top = last["top"][i]
                seen.setdefault(b[0].uid, []).append(
                    (b[0].generated[-1], float(top[0] - top[1]),
                     float(top[0]), last["kind"], live))
        return out

    eng._read_next, eng._advance_slots = reading, advancing
    eng._chunk_tick = ticking("chunk", chunk)
    eng._decode_tick = ticking("decode", decode)


def check_migrations(prefill, twin, held: list) -> None:
    """At every phase boundary the payload is a copy of the prefill slot's
    prompt K/V, bit for bit, and the twin's slot holds it after the
    splice; ``held`` gets one entry a migration."""
    emit, splice = prefill._emit_migration, twin._splice_migration

    def emitting(slot, req):
        emit(slot, req)
        if req.kv_payload is None:
            return
        n = req.kv_migrated
        k, v = req.kv_payload
        if not (torch.equal(k, prefill.cache["k"][:, slot, :n])
                and torch.equal(v, prefill.cache["v"][:, slot, :n])
                and k.data_ptr() != prefill.cache["k"].data_ptr()):
            raise AssertionError(f"(c1) uid {req.uid}: the payload is not "
                                 f"a copy of the slot's prompt K/V")

    def splicing(slot, req):
        k, v = req.kv_payload
        splice(slot, req)
        n = req.kv_migrated
        if not (torch.equal(twin.cache["k"][:, slot, :n], k)
                and torch.equal(twin.cache["v"][:, slot, :n], v)):
            raise AssertionError(f"(c1) uid {req.uid}: the twin's slot "
                                 f"does not hold the migrated K/V")
        held.append(n)

    prefill._emit_migration, twin._splice_migration = emitting, splicing


def bf16_unit(x: float) -> float:
    """One bf16 unit (8 significant bits) at ``x``."""
    return 2.0 ** (np.floor(np.log2(max(abs(x), 1e-30))) - 7)


def c1_pair(arch, batch, fresh, server_of, ticks, tally) -> None:
    """(c1) one architecture at one ``max_batch``: test_disagg's queries
    unified and as a prefill engine plus a decode twin, the migrated K/V
    bit-equal to the prefill slot's.  At max_batch 1 every decode token
    runs through ``serve_step`` at batch 1 in both runs, so the tokens
    must be identical.  At 2 the unified engine's decode tokens ride in
    chunk ticks while a neighbour prefills (the twin decodes them in
    decode ticks), and a MoE layer's expert groups hold the neighbours'
    tokens: other kernels, other bf16 rounding, amplified by the random
    full-depth stack.  A divergence there passes when it is a rounding
    tie (the top-two logit gap at the first diverging token, in either
    run, within one bf16 unit) or when the path explains it: some decode
    token of the uid up to it rode a chunk tick in the unified run, or,
    in a MoE model, some token up to it shared its tick with another live
    row in either run.  A divergence along the same path fails."""
    from repro_torch.core.router import GreenServRouter

    n_moe = fresh(arch).cfg.n_layers if arch == MOE_ARCH else 0
    runs, seen = {}, {}
    t = time.perf_counter()
    for mode in ("unified", "disaggregated"):
        reset_launches()
        eng = fresh(arch, batch=batch)
        twin = (fresh(arch, "decode", batch=batch)
                if mode == "disaggregated" else None)
        seen[mode], held = {}, []
        record_tokens(eng, seen[mode])
        if twin is not None:
            record_tokens(twin, seen[mode])
            check_migrations(eng, twin, held)
        server = server_of(eng, twin)
        with routed(GreenServRouter) as ledger:
            for q in disagg_queries(DISAGG_QUERIES, DISAGG_SEED):
                server.enqueue(q)
                server.step()
            server.run_until_drained(max_steps=2_000)
        torch.cuda.synchronize()
        parts = [eng] + ([twin] if twin is not None else [])
        tally(ledger_launches(f"(c1) {arch} B={batch} {mode}", ledger,
                              ticks(*parts), n_moe))
        runs[mode] = (server, eng, twin, held)
    secs = time.perf_counter() - t
    what = f"(c1) {arch} max_batch {batch}"
    uni, dis = runs["unified"][0], runs["disaggregated"][0]
    eng, twin, held = runs["disaggregated"][1:]
    if not (sorted(uni.responses) == sorted(dis.responses)
            == list(range(DISAGG_QUERIES))):
        raise AssertionError(f"{what}: answered {sorted(uni.responses)} / "
                             f"{sorted(dis.responses)}")
    if not (dis.stats["migrations"] == len(held) > 0
            and eng.cumulative_joules_by_phase()["decode"] == 0
            and twin.cumulative_joules_by_phase()["decode"] > 0):
        raise AssertionError(f"{what}: {dis.stats['migrations']} "
                             f"migrations, {len(held)} landed; phases "
                             f"{eng.cumulative_joules_by_phase()} / "
                             f"{twin.cumulative_joules_by_phase()}")
    ties = []
    for uid in range(DISAGG_QUERIES):
        a = [x[0] for x in seen["unified"][uid]]
        b = [x[0] for x in seen["disaggregated"][uid]]
        if a == b and uni.responses[uid].tokens == dis.responses[uid].tokens:
            continue
        p = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        if p == min(len(a), len(b)):
            raise AssertionError(f"{what}: uid {uid} generated {a} unified "
                                 f"and {b} disaggregated")
        gaps = {m: seen[m][uid][p][1:3] for m in seen}
        units = {m: bf16_unit(top) for m, (_, top) in gaps.items()}
        tie = any(gaps[m][0] <= units[m] for m in gaps)
        steps = {m: seen[m][uid][:p + 1] for m in seen}
        rode = [t for t, x in enumerate(steps["unified"])
                if t and x[3] == "chunk"]
        shared = [t for t in range(p + 1) if n_moe and any(
            steps[m][t][4] > 1 for m in steps)]
        log("resilience", f"{what}: uid {uid} diverges at token {p}: "
            f"unified {a[p:p + 3]} vs disaggregated {b[p:p + 3]}; top-two "
            f"logit gap " + " / ".join(
                f"{gaps[m][0]:.6g} ({m}; one bf16 unit at its top logit "
                f"{gaps[m][1]:.6g} is {units[m]:.6g})" for m in gaps)
            + f"; unified tokens 1..{p} that rode chunk ticks: {rode}"
            + (f"; tokens whose MoE tick held another live row: {shared}"
               if n_moe else ""))
        if batch == 1 or not (tie or rode or shared):
            raise AssertionError(f"{what}: uid {uid} diverged at token {p} "
                                 f"along the same path, top-two gaps "
                                 f"{gaps}")
        ties.append(uid)
    wh = [sum(r.energy_wh for r in s.responses.values()) for s in (uni, dis)]
    log("resilience", f"{what} (bf16, chunk {SERVE_CHUNK}): "
        f"{DISAGG_QUERIES}/{DISAGG_QUERIES} answered both ways in "
        f"{secs:.2f} s; tokens identical for {DISAGG_QUERIES - len(ties)}/"
        f"{DISAGG_QUERIES} uids"
        + (f" (uids {ties} diverge as above)" if ties else "")
        + f"; {len(held)} migrations of {held} prompt tokens, each payload "
        f"bit-equal to the prefill slot and to the twin's slot after the "
        f"splice; {uni._step_idx} / {dis._step_idx} steps; {wh[0]:.9f} / "
        f"{wh[1]:.9f} Wh; the prefill engine's decode ledger 0 J, the "
        f"twin's prefill ledger "
        f"{twin.cumulative_joules_by_phase()['prefill']:.6f} J == its "
        f"migration transfers {twin._migration_joules:.6f} J")


def disagg_part(dev, engines, tally) -> None:
    """(c) disaggregated prefill/decode at full width on the serving
    weights: (c1) unified vs prefill + decode twin on test_disagg's
    queries, (c2) the disaggregation bench's MMPP workload, (c3) the twin
    and then the prefill engine killed under a ``FaultInjector``, (c4) the
    launcher's ``serve`` with ``--disaggregate``."""
    from repro_torch.benchmarks import disagg as disagg_bench
    from repro_torch.configs import get_config
    from repro_torch.core.energy import (CostModelParams, decode_step_cost,
                                         roofline)
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.router import GreenServRouter
    from repro_torch.core.types import RouterConfig
    from repro_torch.data import tokenizer as tok
    from repro_torch.launch import serve as launcher
    from repro_torch.serving import (FaultInjector, FaultSpec, ModelEngine,
                                     PoolServer)

    def fresh(arch, role="unified", batch=DISAGG_BATCH):
        src = engines[arch]
        return ModelEngine(arch, src.cfg, params=src.params, max_batch=batch,
                           max_len=SERVE_MAX_LEN, detokenize=tok.decode,
                           prefill_chunk=SERVE_CHUNK, role=role, device=dev)

    def server_of(eng, twin=None, **kw):
        router = GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05),
                                 ModelPool([eng.profile]), device=dev)
        return PoolServer(router, {eng.name: eng}, tokenizer=tok.encode,
                          prefill_chunk=SERVE_CHUNK,
                          decode_engines={eng.name: twin} if twin else None,
                          **kw)

    def ticks(*engs):
        return sum(sum(e.tick_counts.values()) for e in engs)

    # (c1) unified == disaggregated, token for token
    for arch in DISAGG_ARCHS:
        for batch in DISAGG_C1_BATCHES:
            c1_pair(arch, batch, fresh, server_of, ticks, tally)

    # (c2) the MMPP workload, monolithic 2B slots vs the pair B + B
    src = engines["granite-3-8b"]
    smoke = get_config("granite-3-8b", smoke=True, vocab_size=tok.VOCAB_SIZE,
                       dtype="float32", max_seq_len=disagg_bench.MAX_LEN)
    smoke_cp = CostModelParams(
        n_params=float(smoke.param_count()),
        n_active_params=float(smoke.active_param_count()),
        d_model=smoke.d_model, n_layers=smoke.n_layers,
        kv_heads=max(smoke.n_kv_heads, 1), head_dim=smoke.head_dim)
    scale = (roofline(*decode_step_cost(src.cost_params, 64), 0.0, 1).t_step
             / roofline(*decode_step_cost(smoke_cp, 64), 0.0, 1).t_step)
    queries, arrivals = disagg_bench.make_workload(
        DISAGG_USERS, seed=0, calm_s=2e-6 * scale, burst_s=2.5e-7 * scale)
    runs = {}
    t = time.perf_counter()
    for d in (False, True):
        reset_launches()
        with routed(GreenServRouter) as ledger:
            r = disagg_bench.drive(
                queries, arrivals, disaggregate=d, arch="granite-3-8b",
                slots_per_role=DISAGG_BATCH, prefill_chunk=SERVE_CHUNK,
                cfg=src.cfg, params=src.params, max_len=SERVE_MAX_LEN,
                device=dev)
        torch.cuda.synchronize()
        tally(ledger_launches(f"(c2) {r['mode']}", ledger))
        r["seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        runs[r["mode"]] = r
    mono, dis = runs["monolithic"], runs["disaggregated"]
    if not (mono["completed"] == dis["completed"] == len(queries)
            and dis["migrations"] > 0 and mono["migrations"] == 0
            and dis["role_wh"]["prefill"] > 0 and dis["role_wh"]["decode"] > 0
            and mono["role_wh"]["unified"] > 0):
        raise AssertionError(f"(c2) {mono['completed']} / {dis['completed']} "
                             f"of {len(queries)} answered; migrations "
                             f"{mono['migrations']} / {dis['migrations']}; "
                             f"role Wh {mono['role_wh']} / {dis['role_wh']}")
    for r in (mono, dis):
        log("resilience", f"(c2) {r['mode']}: {r['completed']}/"
            f"{len(queries)} answered in {r['seconds']:.2f} s "
            f"({r['steps']} steps), TTFT p50/p95/p99 {r['ttft_p50_s']:.6g} /"
            f" {r['ttft_p95_s']:.6g} / {r['ttft_p99_s']:.6g} modeled s, "
            f"{r['joules_per_query']:.6g} J a query, {r['migrations']} "
            f"migrations, role Wh {r['role_wh']}")
    cut = {k: 1 - dis[k] / max(mono[k], 1e-12)
           for k in ("ttft_p99_s", "joules_per_query")}
    log("resilience", f"(c2) {len(queries)} users, timescales x{scale:.6g} "
        f"the bench's (calm {2e-6 * scale:.6g} s, burst "
        f"{2.5e-7 * scale:.6g} s): p99 TTFT cut {cut['ttft_p99_s']:.2%}, "
        f"J/query cut {cut['joules_per_query']:.2%} (reported, not gated)")

    # (c3) the decode twin, then the prefill engine, killed mid-stream
    clk = {"t": 0.0}
    eng, twin = fresh("granite-3-8b"), fresh("granite-3-8b", "decode")
    p_inj = FaultInjector(eng, [], clock=lambda: clk["t"])
    d_inj = FaultInjector(twin, [], clock=lambda: clk["t"])
    server = server_of(p_inj, d_inj, clock=lambda: clk["t"],
                       heartbeat_timeout_s=1e18, max_retries=2,
                       retry_backoff_steps=1)
    queries = disagg_queries(DISAGG_KILL_QUERIES, 13, (4, 9))
    reset_launches()
    t = time.perf_counter()
    kills = {}
    with routed(GreenServRouter) as ledger:
        server.enqueue_many(queries)
        for _ in range(2_000):
            if not server.inflight and not server.arrivals:
                break
            server.step()
            clk["t"] += 1.0
            if "decode" not in kills and any(s is not None
                                             for s in twin.slots):
                d_inj.faults = [FaultSpec(t_s=clk["t"], kind="crash")]
                kills["decode"] = (clk["t"], len(server.inflight))
            elif ("decode" in kills and "prefill" not in kills
                  and clk["t"] > kills["decode"][0] + 2
                  and any(s is not None for s in eng.slots)):
                p_inj.faults = [FaultSpec(t_s=clk["t"], kind="crash")]
                kills["prefill"] = (clk["t"], len(server.inflight))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    tally(ledger_launches("(c3) kills", ledger))
    uids = {q.uid for q in queries}
    if not (set(server.responses) | set(server.failed) == uids
            and not set(server.responses) & set(server.failed)
            and len(kills) == 2 and p_inj.stats["crashes"] == 1
            and d_inj.stats["crashes"] == 1
            and server.stats["restarts"] >= 2):
        raise AssertionError(f"(c3) responses {sorted(server.responses)}, "
                             f"failed {sorted(server.failed)}, kills {kills}, "
                             f"crashes {p_inj.stats} / {d_inj.stats}, stats "
                             f"{server.stats}")
    log("resilience", f"(c3) the decode twin killed at step "
        f"{kills['decode'][0]:.0f} ({kills['decode'][1]} in flight), the "
        f"prefill engine at step {kills['prefill'][0]:.0f} "
        f"({kills['prefill'][1]} in flight), through FaultInjector crashes: "
        f"{len(server.responses)} answered + {len(server.failed)} failed == "
        f"{len(uids)} uids, each once; {server.stats['restarts']} restarts, "
        f"{server.stats['retries']} retries, {server.stats['migrations']} "
        f"migrations, {server._step_idx} steps in {secs:.2f} s")

    # (c4) the launcher's serve with --disaggregate over its default pool
    args = launcher.build_parser().parse_args(
        ["--queries", str(DISAGG_LAUNCHER_QUERIES), "--disaggregate",
         "--device", str(dev)])
    prim = {a: fresh(a, batch=4) for a in args.pool}
    twins = {a: fresh(a, "decode", batch=4) for a in args.pool}
    moe = [e for e in (prim.get(MOE_ARCH), twins.get(MOE_ARCH)) if e]
    reset_launches()
    t = time.perf_counter()
    with routed(GreenServRouter) as ledger:
        run = launcher.serve(args, prim,
                             ModelPool([e.profile for e in prim.values()]),
                             twins)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    tally(ledger_launches("(c4) the launcher", ledger, ticks(*moe),
                          engines[MOE_ARCH].cfg.n_layers))
    server = run["server"]
    # the launcher draws --queries // 5 stream queries a task: 10 for 12
    if not (len(server.responses) == len(run["queries"])
            == DISAGG_LAUNCHER_QUERIES // 5 * 5
            and prim[RWKV_ARCH].role == "unified"
            and RWKV_ARCH not in server.decode_engines
            and all(server.decode_engines[a].role == "decode"
                    and prim[a].role == "prefill"
                    for a in args.pool if a != RWKV_ARCH)):
        raise AssertionError(f"(c4) {len(server.responses)}/"
                             f"{len(run['queries'])} answered; roles "
                             f"{ {a: e.role for a, e in prim.items()} }; "
                             f"twins {list(server.decode_engines)}")
    router = run["router"]
    log("resilience", f"(c4) launcher --disaggregate over {args.pool}: "
        f"{len(server.responses)}/{len(run['queries'])} answered (--queries "
        f"{DISAGG_LAUNCHER_QUERIES}) in "
        f"{secs:.2f} s ({server._step_idx} steps), rwkv6 unified, twins for "
        f"{sorted(server.decode_engines)}; {server.stats['migrations']} "
        f"migrations; arms "
        f"{dict(zip(router.pool.names, map(int, router.selection_counts())))}")


def resilience_phase(dev, engines) -> dict:
    """The serving path under faults, bursts and churn on the card, every
    router with featurize "auto": (a) the scenario lab, (b) the chaos
    drill, (c) disaggregation at full width.  Returns the router kernels'
    and the gating kernel's launches."""
    launches = {"featurize": 0, "linucb": 0, "moe_gating": 0}

    def tally(got):
        for k in launches:
            launches[k] += got.get(k, 0)

    for name, part in (("(a) scenarios", lambda: scenario_part(dev, tally)),
                       ("(b) chaos", lambda: chaos_part(dev, tally)),
                       ("(c) disaggregation",
                        lambda: disagg_part(dev, engines, tally))):
        t = time.perf_counter()
        part()
        gc.collect()
        log("resilience", f"{name}: {time.perf_counter() - t:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# 5e. the fleet: sharded pools, the feedback all-reduce, fail-over and
#     fleet checkpoints
# ---------------------------------------------------------------------------


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def counted_route_calls(router_cls):
    """While active, count every non-empty ``route_batch`` call of
    ``router_cls`` (host-featurize routers: one LinUCB launch each)."""
    route, calls = router_cls.route_batch, [0]

    def counting(self, queries, *args, **kwargs):
        calls[0] += bool(queries)
        return route(self, queries, *args, **kwargs)

    router_cls.route_batch = counting
    try:
        yield calls
    finally:
        router_cls.route_batch = route


def fleet_record_check(what: str, got: dict, want: dict) -> None:
    """Every field of ``want`` equal in ``got`` (floats as the JAX
    package's bench rounds them)."""
    differ = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if differ:
        raise AssertionError(f"{what}: differs from the JAX package's CPU "
                             f"figures (got, want): {differ}")


def update_parity(dev) -> None:
    """The bandit update on the card rounds as on the CPU, bit for bit
    (the CPU's is the JAX package's: ``tests/test_torch_fleet.py``), over
    300 updates with the router's one-hot contexts and dense ones; its
    time a feedback on the host clock."""
    from repro_torch.core.bandits import BanditPolicy
    from repro_torch.core.types import RouterConfig

    rng = np.random.default_rng(0)
    steps = []
    for i in range(300):
        x = np.zeros(12, np.float32)
        x[[rng.integers(5), 5 + rng.integers(4), 9 + rng.integers(2),
           11]] = 1.0
        if i % 3 == 2:
            x = rng.standard_normal(12).astype(np.float32)
        steps.append((int(rng.integers(16)), x, float(rng.standard_normal())))
    card, host = (BanditPolicy(RouterConfig(max_arms=32), 16, device=d)
                  for d in (dev, "cpu"))
    for arm, x, r in steps[:20]:
        card.update(arm, x, r)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for arm, x, r in steps[20:]:
        card.update(arm, x, r)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) / (len(steps) - 20) * 1e3
    for arm, x, r in steps:
        host.update(arm, x, r)
    got, want = card.state_dict(), host.state_dict()
    differ = [k for k in want if not np.array_equal(got[k], want[k])]
    if differ:
        raise AssertionError(f"the update on the card rounds otherwise than "
                             f"on the CPU in {differ}")
    log("fleet", f"bandit update: card == CPU bit for bit over "
        f"{len(steps)} updates; {ms:.4f} ms a feedback on the card (host "
        f"clock, synchronized)")


def pool_scale_part(dev, tally) -> None:
    """(a) ``pool_scale.main(smoke=True)`` with its three assertions, once
    with featurize "auto" (the device path) and once "host": the two
    records equal in every field but the wall-clock decision time, and
    equal to the JAX package's CPU figures."""
    from repro_torch.benchmarks import pool_scale
    from repro_torch.core.router import GreenServRouter

    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    records, lines = {}, {}
    for featurize in ("auto", "host"):
        path = out / f"BENCH_pool_scale_{featurize}.json"
        reset_launches()
        t = time.perf_counter()
        if featurize == "auto":
            with routed(GreenServRouter) as ledger:
                lines[featurize] = pool_scale.main(
                    smoke=True, artifact=str(path), device=dev)
            tally(ledger_launches("(a) pool scale, device featurize",
                                  ledger))
            calls = len(ledger["batches"])
        else:
            with counted_route_calls(GreenServRouter) as counted:
                lines[featurize] = pool_scale.main(
                    smoke=True, artifact=str(path), device=dev,
                    featurize="host")
            got, calls = read_launches(), counted[0]
            if (got["featurize"], got["linucb"]) != (0, calls):
                raise AssertionError(f"(a) pool scale, host featurize: "
                                     f"launches {got}, {calls} routing "
                                     f"calls")
            tally({"linucb": calls})
            reset_launches()
        secs = time.perf_counter() - t
        runs = json.loads(path.read_text())["runs"]
        records[featurize] = runs
        log("fleet", f"(a) pool scale --smoke, featurize {featurize}: "
            f"{secs:.2f} s, {calls} routing calls; " + " | ".join(
                lines[featurize][:-1]))
    decision = {f: {n: r.pop("mean_decision_ms") for n, r in runs.items()}
                for f, runs in records.items()}
    if records["auto"] != records["host"]:
        differ = [n for n in records["auto"]
                  if records["auto"][n] != records["host"][n]]
        raise AssertionError(f"(a) device and host featurize records "
                             f"differ in {differ}")
    for name, want in POOL_SCALE_JAX.items():
        fleet_record_check(f"(a) {name}", records["auto"][name], want)
    ms = {n: (decision["auto"][n], decision["host"][n])
          for n in decision["auto"]}
    figures = {n: (w["completed"], w["span_s"], w["throughput_qps"])
               for n, w in POOL_SCALE_JAX.items()}
    log("fleet", f"(a) device == host featurize records in every field but "
        f"the decision time (ms a query, device / host: {ms}); both == the "
        f"JAX package's CPU figures (answered, span, q/s): {figures}")


def fleet_chaos_part(dev, tally) -> None:
    """(b) the fleet chaos variant: three shards, shard 0's engines in the
    fault storm, shard 2 killed; the JAX package's record."""
    from repro_torch.benchmarks import chaos
    from repro_torch.core.router import GreenServRouter

    reset_launches()
    t = time.perf_counter()
    with routed(GreenServRouter) as ledger:
        rec = chaos.run_fleet_chaos(n=FLEET_CHAOS_N, device=dev)
    secs = time.perf_counter() - t
    tally(ledger_launches("(b) fleet chaos", ledger))
    fleet_record_check("(b) fleet chaos", rec, FLEET_CHAOS_JAX)
    log("fleet", f"(b) fleet chaos (n {FLEET_CHAOS_N}): {rec['completed']} "
        f"answered, {rec['failed']} failed, span {rec['span_s']} modeled s, "
        f"stats {rec['stats']}, fail-over at t {rec['events'][0]['t']:.6g} "
        f"modeled s; == the JAX package's CPU record; "
        f"{len(ledger['batches'])} routing calls in {secs:.2f} s")


def fleet_full_width(dev, engines, tally) -> None:
    """(c) a two-shard fleet at full width on one card: each shard a
    ``PoolServer`` over h2o-danube-3-4b and qwen2-moe-a2.7b (bf16,
    ``use_pallas=True``, the serving engines' weights), its router on the
    card with featurize "auto"; Poisson arrivals on the virtual clock,
    shard 1 killed through ``drive_fleet``; then the fleet's checkpoint
    restored into a fresh fleet of the same shape."""
    import shutil

    from repro_torch.core.energy import decode_step_cost, roofline
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.router import GreenServRouter
    from repro_torch.core.types import RouterConfig
    from repro_torch.data import stream as stream_lib
    from repro_torch.data import tokenizer as tok
    from repro_torch.data.scenarios import poisson_arrivals
    from repro_torch.fleet import (base_model_name, build_fleet, drive_fleet,
                                   plan_fleet)
    from repro_torch.serving.engine import ModelEngine

    def engine_factory(profile, spec):
        src = engines[base_model_name(profile.name)]
        return ModelEngine(profile.name, src.cfg, params=src.params,
                           max_batch=4, max_len=SERVE_MAX_LEN,
                           detokenize=tok.decode, prefill_chunk=SERVE_CHUNK,
                           device=dev)

    def router_factory(spec):
        return GreenServRouter(
            RouterConfig(lam=0.4, energy_scale_wh=0.05, seed=spec.index),
            ModelPool([engines[a].profile for a in FLEET_ARCHS]), device=dev)

    # the virtual clock's scale: the slower model's modeled decode tick
    tick = max(roofline(*decode_step_cost(engines[a].cost_params,
                                          SERVE_MAX_LEN), 0.0, 1).t_step
               for a in FLEET_ARCHS)

    def build(clk):
        plan = plan_fleet(2, list(FLEET_ARCHS), devices=[dev])
        return plan, build_fleet(
            plan, router_factory, engine_factory,
            sync_every=FLEET_SYNC_EVERY,
            heartbeat_timeout_s=FLEET_HEARTBEAT_TICKS * tick,
            clock=lambda: clk["t"],
            server_kwargs=dict(tokenizer=tok.encode,
                               accuracy_fn=exact_match_accuracy,
                               prefill_chunk=SERVE_CHUNK))

    clk = {"t": 0.0}
    plan, ctrl = build(clk)
    queries = stream_lib.make_stream(per_task=FLEET_QUERIES // 5 + 1,
                                     seed=1)[:FLEET_QUERIES]
    arrivals = poisson_arrivals(len(queries), 1.0 / (FLEET_GAP_TICKS * tick),
                                seed=2)
    survivor, victim = (ctrl.shards[s.name] for s in plan.shards)
    t_kill = arrivals[int(FLEET_KILL_FRAC * len(arrivals))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    t = time.perf_counter()
    with routed(GreenServRouter) as ledger:
        traj = drive_fleet(ctrl, queries, arrivals, clk, events=[
            (t_kill, lambda: ctrl.kill_shard(victim.name))])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    every = [e for s in ctrl.shards.values()
             for e in s.server.engines.values()]
    moe = [e for e in every if e.cfg.layout == "moe"]
    tally(ledger_launches("(c) full-width fleet", ledger,
                          sum(sum(e.tick_counts.values()) for e in moe),
                          engines[MOE_ARCH].cfg.n_layers))
    adopted = [n for n in survivor.server.engines
               if n.endswith(f"@{victim.name}")]
    served = {n: sum(r.model_name == n for r in ctrl.responses.values())
              for n in survivor.server.engines}
    s = ctrl.stats
    gates = [
        (len(ctrl.responses) == len(queries) and not ctrl.failures
         and not ctrl.unanswered, "every query answered, none failed"),
        (s["failovers"] == 1 and len(ctrl.events) == 1,
         "exactly one fail-over"),
        (s["redispatched"] > 0, "the kill stranded queries on shard 1"),
        (len(adopted) == 2 and all(served[n] > 0 for n in adopted),
         "two adopted engines on the survivor, each serving"),
        (s["syncs"] > 0, "the all-reduce ran"),
        (not any(e.nonfinite_ticks for e in every), "finite logits")]
    failed = [m for ok, m in gates if not ok]
    if failed:
        raise AssertionError(f"(c) full-width fleet: {failed}: stats {s}, "
                             f"served {served}, events {ctrl.events}")
    peak = torch.cuda.max_memory_allocated(dev)
    log("fleet", f"(c) full-width fleet {FLEET_ARCHS} x 2 shards on "
        f"{card_line()}: {len(ctrl.responses)}/{len(queries)} answered in "
        f"{secs:.2f} s, {ctrl._steps} fleet steps "
        f"({secs / ctrl._steps * 1e3:.3f} ms each), span "
        f"{clk['t']:.6g} modeled s (decode tick {tick:.6g} s); stats {s}; "
        f"fail-over at t {ctrl.events[0]['t']:.6g} (kill at {t_kill:.6g}), "
        f"{ctrl.events[0]['redispatched']} redispatched; served {served}; "
        f"{len(ledger['batches'])} routing calls, "
        f"{sum(sum(e.tick_counts.values()) for e in moe)} MoE ticks; "
        f"max_memory_allocated {peak} bytes; trajectory's last sample "
        f"{traj[-1]}")

    # the checkpoint: a fresh fleet of the same shape (the survivor's
    # adopted arms added) restored from it routes a probe like the saved
    # fleet, shard by shard
    ckdir = ROOT / "build" / "fleet_checkpoint"
    shutil.rmtree(ckdir, ignore_errors=True)
    t = time.perf_counter()
    ctrl.save_checkpoint(str(ckdir), step=ctrl._steps)
    _, fresh = build({"t": 0.0})
    pool = survivor.server.router.pool
    for name in adopted:
        profile = pool[pool.names.index(name)]
        fresh.shards[survivor.name].server.add_engine(
            profile, engine_factory(profile, survivor.spec))
    if fresh.load_checkpoint(str(ckdir)) != ctrl._steps:
        raise AssertionError("(c) the checkpoint restored another step")
    probe = stream_lib.make_stream(per_task=2, seed=7)[:FLEET_PROBE]
    reset_launches()
    with routed(GreenServRouter) as ledger:
        arms = {name: ([d.model_index for d in
                        shard.server.router.route_batch(probe)],
                       [d.model_index for d in fresh.shards[name].server
                        .router.route_batch(probe)])
                for name, shard in ctrl.shards.items()}
    tally(ledger_launches("(c) checkpoint probe", ledger))
    if any(a != b for a, b in arms.values()):
        raise AssertionError(f"(c) the restored fleet routes otherwise: "
                             f"{arms}")
    shutil.rmtree(ckdir, ignore_errors=True)
    log("fleet", f"(c) save_checkpoint / load_checkpoint into a fresh "
        f"2-shard fleet in {time.perf_counter() - t:.2f} s: the same arms "
        f"on a {FLEET_PROBE}-query probe, shard by shard: "
        f"{ {n: a for n, (a, _) in arms.items()} }")


def fleet_phase(dev, engines) -> dict:
    """The fleet on the card (``repro_torch.fleet``), after the bandit
    update's parity with the CPU: (a) the pool-scale bench, (b) the fleet
    chaos variant, (c) a full-width fleet.  Returns the router kernels'
    and the gating kernel's launches."""
    launches = {"featurize": 0, "linucb": 0, "moe_gating": 0}

    def tally(got):
        for k in launches:
            launches[k] += got.get(k, 0)

    update_parity(dev)
    for name, part in (("(a) pool scale", lambda: pool_scale_part(dev, tally)),
                       ("(b) fleet chaos",
                        lambda: fleet_chaos_part(dev, tally)),
                       ("(c) full-width fleet",
                        lambda: fleet_full_width(dev, engines, tally))):
        t = time.perf_counter()
        part()
        gc.collect()
        log("fleet", f"{name}: {time.perf_counter() - t:.2f} s")
    return launches


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
    if cfg.layout in ("dense", "moe", "encdec"):     # encdec: the decoder
        want["flash_attention"] = cfg.n_layers
    if cfg.layout == "moe":
        want["moe_gating"] = cfg.n_layers
    if cfg.layout == "rwkv":
        want["rwkv6"] = cfg.n_layers
    if cfg.layout == "mamba_hybrid":
        want["mamba2"] = cfg.n_layers
        want["flash_attention"] = cfg.n_layers // cfg.attn_every
    return want


def drive_prefill(dev, arch, model, cfg, b: int, s: int, rng,
                  frontend: str = "") -> tuple:
    """``api.prefill`` at (b, s) with the counts set to 0 just before and
    read just after (the launches must be ``expected_launches``, the
    logits finite), then timed over two more calls.  ``frontend`` names a
    stub frontend's batch entry ("frames", "frontend_embeddings"), given
    ``cfg.n_frontend_tokens`` seeded N(0, 1) embeddings a row.  Returns
    (launches, the batch)."""
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import api

    batch = {"tokens": torch.from_numpy(
        rng.integers(3, tok.VOCAB_SIZE, (b, s)).astype(np.int32)).to(dev)}
    if frontend:
        batch[frontend] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.d_model), np.float32)).to(
                dev, cfg.torch_dtype())
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
    front = (f" + {cfg.n_frontend_tokens} stub {frontend}" if frontend
             else "")
    log("prefill", f"{arch} B={b} S={s}{front}: launches "
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
        raise AssertionError(f"{cfg.name} lockstep decode: launches "
                             f"{launches}, expected {want}")
    if (cache["length"].ndim != 0 or int(cache["length"]) != length + steps
            or tuple(logits.shape) != (b, 1, cfg.vocab_size)
            or not torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name} lockstep decode: length "
                             f"{cache['length']}, logits "
                             f"{tuple(logits.shape)} finite "
                             f"{bool(torch.isfinite(logits).all())}")
    rest = step_ms[1:]
    mean = sum(rest) / len(rest)
    dev_ms, top = profile_steps(model, cfg, cache,
                                tokens[:GEMMA_PROFILE_STEPS])
    log("gemma3", f"{cfg.name} lockstep decode B={b}, cache depth {depth} "
        f"(rings "
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
    log("profile", f"{cfg.name} lockstep decode, {GEMMA_PROFILE_STEPS} more "
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
    return kernel_times(prof, len(tokens), f"{cfg.name} lockstep decode")


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
            raise AssertionError(f"{cfg.name}, first {n} layers, {label}: "
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
            check_flash_route(f"{cfg.name} {what} {index}, {label}",
                              "wgmma" if label == "bf16" else "scalar")
            kv_gap = view_cache_gap(lv, lc, fed, toks)
            del fed
            want = feed if what == "global layer" else 0
            if launches != want:
                raise AssertionError(f"{cfg.name} {what} {index}, {label}: "
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
    # the loop's last views hold the fp32 upcast too
    del m32, cut32, m, c, lv, lc
    torch.cuda.empty_cache()
    if fails:
        raise AssertionError(f"{cfg.name} checks: {'; '.join(fails)}")
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


# ---------------------------------------------------------------------------
# 10. the other families and the paper's remaining experiments: whisper,
#     gemma3-27b, llava, grok at full width; the paper benches
# ---------------------------------------------------------------------------


def family_model(dev, arch: str, seed: int, **cut) -> tuple:
    """(a full-width bf16 model of ``arch`` with random weights from
    ``seed``, its ``use_pallas=True`` config cut by ``cut``), logged."""
    from repro_torch.configs import for_mode, get_config
    from repro_torch.data import tokenizer as tok
    from repro_torch.models import api

    torch.cuda.reset_peak_memory_stats(dev)
    full = get_config(arch)
    cfg = for_mode(get_config(arch, vocab_size=tok.VOCAB_SIZE,
                              max_seq_len=SERVE_MAX_LEN, use_pallas=True,
                              **cut), "serve")
    t = time.perf_counter()
    model = api.init_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    enc = (f" + {cfg.n_encoder_layers} encoder layers"
           if cfg.layout == "encdec" else "")
    log("families", f"{arch}: {cfg.n_layers}/{full.n_layers} layers{enc}, "
        f"d_model {cfg.d_model}, {cfg.compute_heads}/{cfg.n_kv_heads} heads "
        f"of {cfg.head_dim}, d_ff {cfg.d_ff}"
        + (f", {cfg.n_experts} experts top-{cfg.top_k}"
           if cfg.layout == "moe" else "")
        + f"; {n_params / 1e9:.3f} B params, {weights} bytes in bf16, built "
        f"in {time.perf_counter() - t:.2f} s")
    return model, cfg


def wall_ms(fn, reps: int = 2) -> float:
    """Host milliseconds a call of ``fn`` over ``reps`` calls ending in a
    synchronize, after one call."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def encdec_view(model, cfg, n: int) -> tuple:
    """(a view of an encoder-decoder holding its first ``n`` encoder and
    decoder layers, weights shared, and ``cfg`` cut to them)."""
    view = copy.copy(model)
    view._modules = dict(model._modules)
    view.enc_layers = torch.nn.ModuleList(model.enc_layers[:n])
    view.dec_layers = torch.nn.ModuleList(model.dec_layers[:n])
    return view, dataclasses.replace(cfg, n_layers=n, n_encoder_layers=n)


def whisper_pallas_check(model, cfg, batch) -> None:
    """At the first ``PREFILL_CHECK_DEPTH`` encoder and decoder layers,
    ``use_pallas`` True (the decoder's self-attention on the flash kernel)
    against False, in bf16.  Checked on zero frames, the serving engine's
    stub frontend: the encoder output and the cross K/V are then 0, so
    cross-attention adds nothing, as in serving.  With N(0, 1) frames the
    random cross-attention is nearly one-hot and chaotic (a bf16 rounding
    of its query can move its weight to another frame), so that gap is
    printed beside the yardstick of the same amplification: the plain
    path's own gap when every frame moves by about one bf16 unit."""
    from repro_torch.models import api

    n = PREFILL_CHECK_DEPTH
    view, vcfg = encdec_view(model, cfg, n)
    plain = dataclasses.replace(vcfg, use_pallas=False)
    frames = batch["frames"]
    sign = torch.where(torch.rand(frames.shape, device=frames.device,
                                  generator=torch.Generator(
                                      frames.device).manual_seed(5)) < 0.5,
                       -1.0, 1.0)
    nudged = (frames.float() * (1 + 2.0 ** -8 * sign)).to(frames.dtype)
    gaps = {}
    for what, fr in (("zero frames", torch.zeros_like(frames)),
                     ("N(0, 1) frames", frames)):
        b = dict(batch, frames=fr)
        gaps[what] = logit_gap(api.prefill(view, b, vcfg),
                               api.prefill(view, b, plain))
    base = api.prefill(view, batch, plain)
    yardstick = logit_gap(api.prefill(view, dict(batch, frames=nudged),
                                      plain), base)
    log("families", f"{cfg.name}, first {n} layers, bf16, use_pallas True "
        f"vs False: zero frames max |diff| {gaps['zero frames'][0]:.7f} of "
        f"the logit range (mean {gaps['zero frames'][1]:.7f}), limit "
        f"{PREFILL_REL_TOL}; N(0, 1) frames {gaps['N(0, 1) frames'][0]:.7f} "
        f"(mean {gaps['N(0, 1) frames'][1]:.7f}), not checked, beside the "
        f"plain path's own gap when the frames move by one bf16 unit: "
        f"{yardstick[0]:.7f} (mean {yardstick[1]:.7f})")
    if not gaps["zero frames"][0] <= PREFILL_REL_TOL:
        raise AssertionError(f"{cfg.name}: use_pallas True vs False "
                             f"{gaps['zero frames'][0]:.7f} > "
                             f"{PREFILL_REL_TOL} on zero frames")


def whisper_part(dev, tally) -> dict:
    """whisper-medium at full depth and width: (a1) ``api.prefill`` at
    ``WHISPER_PREFILL`` with 1,500 stub frames, the decoder's self-attention
    on the flash kernel (one wgmma launch a decoder layer), the encoder's
    and the whole prefill's ms apart, and ``whisper_pallas_check``; (a2)
    served beside granite-3-8b (``SERVE_CUTS``) through the launcher's
    ``serve`` at its defaults; (a3) a prefill engine and its decode twin
    at max_batch 1 against a unified engine (``c1_pair``).  Returns the
    prefill's launches."""
    from repro_torch.core.pool import ModelPool
    from repro_torch.core.router import GreenServRouter
    from repro_torch.core.types import RouterConfig
    from repro_torch.data import tokenizer as tok
    from repro_torch.launch import serve as launcher
    from repro_torch.models import api, encdec
    from repro_torch.serving import ModelEngine, PoolServer

    model, cfg = family_model(dev, WHISPER_ARCH, seed=11)
    b, s = WHISPER_PREFILL
    prefill, batch = drive_prefill(dev, WHISPER_ARCH, model, cfg, b, s,
                                   np.random.default_rng(61), "frames")
    enc_ms = wall_ms(lambda: encdec.encode(model, batch["frames"], cfg))
    all_ms = wall_ms(lambda: api.prefill(model, batch, cfg))
    log("families", f"{WHISPER_ARCH} one-shot prefill B={b}, "
        f"{cfg.n_frontend_tokens} frames, S={s}: {all_ms:.3f} ms, of it "
        f"the encoder {enc_ms:.3f} ms ({enc_ms / all_ms:.4f}; plain "
        f"non-causal attention, as the JAX package's) and the decoder "
        f"{all_ms - enc_ms:.3f} ms; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} bytes")
    whisper_pallas_check(model, cfg, batch)
    del batch
    torch.cuda.empty_cache()

    # (a2) beside granite-3-8b through the launcher, at its defaults
    args = launcher.build_parser().parse_args(
        ["--pool", "granite-3-8b", WHISPER_ARCH, "--device", str(dev)])
    granite, gcfg = family_model(dev, "granite-3-8b", seed=12,
                                 **SERVE_CUTS["granite-3-8b"])
    engines = {a: ModelEngine(a, c, params=m, max_batch=4,
                              max_len=SERVE_MAX_LEN, detokenize=tok.decode,
                              prefill_chunk=args.prefill_chunk, device=dev)
               for a, m, c in (("granite-3-8b", granite, gcfg),
                               (WHISPER_ARCH, model, cfg))}
    reset_launches()
    with routed(GreenServRouter) as ledger:
        run = launcher.serve(args, engines,
                             ModelPool([e.profile for e in engines.values()]))
        torch.cuda.synchronize()
    tally(ledger_launches("(a2) whisper beside granite", ledger))
    resp = run["server"].responses
    by_arch = {a: sum(r.model_name == a for r in resp.values())
               for a in engines}
    if len(resp) != len(run["queries"]) or not by_arch[WHISPER_ARCH]:
        raise AssertionError(f"(a2) {len(resp)}/{len(run['queries'])} "
                             f"answered, per model {by_arch}")
    w = engines[WHISPER_ARCH]
    log("families", f"(a2) launcher serve over granite-3-8b + "
        f"{WHISPER_ARCH} (max_batch 4, max_len {SERVE_MAX_LEN}, chunk "
        f"{args.prefill_chunk}): {len(resp)}/{len(run['queries'])} answered "
        f"in {run['wall_s']:.2f} s, per model {by_arch}; whisper ticks "
        f"{w.tick_counts}, cross K/V {tuple(w.cache['cross_k'].shape)} "
        f"(zero: the stub frontend)")
    del engines, run, granite
    gc.collect()
    torch.cuda.empty_cache()

    # (a3) disaggregated at max_batch 1: the exact gate
    def fresh(arch, role="unified", batch=1):
        return ModelEngine(arch, cfg, params=model, max_batch=batch,
                           max_len=SERVE_MAX_LEN, detokenize=tok.decode,
                           prefill_chunk=SERVE_CHUNK, role=role, device=dev)

    def server_of(eng, twin=None):
        router = GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05),
                                 ModelPool([eng.profile]), device=dev)
        return PoolServer(router, {eng.name: eng}, tokenizer=tok.encode,
                          prefill_chunk=SERVE_CHUNK,
                          decode_engines={eng.name: twin} if twin else None)

    def ticks(*engs):
        return sum(sum(e.tick_counts.values()) for e in engs)

    c1_pair(WHISPER_ARCH, 1, fresh, server_of, ticks, tally)
    return prefill


def gemma27_part(dev) -> dict:
    """gemma3-27b at full width, ``GEMMA27_LAYERS`` deep: its one-shot
    prefill and lockstep decode over a 32768-deep cache, with the gemma3 phase's
    checks (``lockstep_decode``, ``gemma3_checks``).  Returns the
    prefill's and the decode's launches."""
    model, cfg = family_model(dev, GEMMA27_ARCH, seed=13,
                              n_layers=GEMMA27_LAYERS)
    prefill, batch = drive_prefill(dev, GEMMA27_ARCH, model, cfg,
                                   *GEMMA_PREFILL, np.random.default_rng(67))
    del batch
    torch.cuda.empty_cache()
    run = lockstep_decode(dev, model, cfg)
    t = time.perf_counter()
    gemma3_checks(dev, model, cfg, run["cache"])
    log("families", f"{GEMMA27_ARCH} checks {time.perf_counter() - t:.2f} "
        f"s; max_memory_allocated {torch.cuda.max_memory_allocated(dev)} "
        f"bytes")
    return {"prefill": prefill, "decode": run["launches"]}


def llava_part(dev) -> dict:
    """llava-next-34b at full width and ``LLAVA_LAYERS`` layers: one-shot
    prefill with its 576 stub patch embeddings before the text."""
    model, cfg = family_model(dev, LLAVA_ARCH, seed=14, n_layers=LLAVA_LAYERS)
    launches, _ = drive_prefill(dev, LLAVA_ARCH, model, cfg, *LLAVA_PREFILL,
                                np.random.default_rng(71),
                                "frontend_embeddings")
    log("families", f"{LLAVA_ARCH}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated(dev)} bytes")
    return launches


def grok_part(dev) -> dict:
    """grok-1-314b at full width and ``GROK_LAYERS`` layers: one-shot
    prefill (the gating kernel at E = 8, k = 2 a layer), then a
    ``ModelEngine`` serving ``GROK_REQUESTS`` with chunked prefill, the
    gating kernel at every MoE layer of every tick."""
    from repro_torch.core.types import Query
    from repro_torch.data import stream as stream_lib
    from repro_torch.data import tokenizer as tok
    from repro_torch.serving import ModelEngine, Request

    model, cfg = family_model(dev, GROK_ARCH, seed=15, n_layers=GROK_LAYERS)
    prefill, batch = drive_prefill(dev, GROK_ARCH, model, cfg, *GROK_PREFILL,
                                   np.random.default_rng(73))
    del batch
    n_req, n_prompt, n_new = GROK_REQUESTS
    eng = ModelEngine(GROK_ARCH, cfg, max_batch=n_req, max_len=SERVE_MAX_LEN,
                      params=model, detokenize=tok.decode,
                      prefill_chunk=SERVE_CHUNK, device=dev)
    eng.submit_many([Request(query=Query(uid=q.uid, text=q.text),
                             prompt_tokens=tok.encode(q.text)[:n_prompt],
                             max_new_tokens=n_new)
                     for q in stream_lib.make_stream(per_task=1,
                                                     seed=5)[:n_req]])
    reset_launches()
    done, t = [], time.perf_counter()
    while eng.pending:
        done += eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    served = read_launches()
    n_ticks = sum(eng.tick_counts.values())
    want = dict.fromkeys(_ops_modules(), 0)
    want["moe_gating"] = cfg.n_layers * n_ticks
    if len(done) != n_req or eng.nonfinite_ticks or served != want:
        raise AssertionError(f"{GROK_ARCH} engine: {len(done)}/{n_req} "
                             f"answered, {eng.nonfinite_ticks} non-finite "
                             f"ticks, launches {served}, expected {want}")
    log("families", f"{GROK_ARCH} engine: {len(done)}/{n_req} requests "
        f"answered ({sum(r.output_tokens for r in done)} tokens) in "
        f"{wall:.3f} s; ticks {eng.tick_counts}, "
        f"{served['moe_gating']} gating launches ({cfg.n_layers} a tick); "
        f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)} bytes")
    return {k: prefill[k] + served[k] for k in prefill}


@contextlib.contextmanager
def router_launches():
    """While active, count the router kernels' launches that the routing
    calls, device cache probes and device encodes of every router make:
    a LinUCB launch per Sherman–Morrison LinUCB call (either featurize
    path), a featurize launch per device-path call that hashes text (a
    task or cluster feature not handed in), per device probe and per
    ``encode_batch_device``.  Yields the running counts."""
    from repro_torch.core.context import ContextGenerator
    from repro_torch.core.embedding import EmbeddingModel
    from repro_torch.core.router import GreenServRouter

    route = GreenServRouter.route_batch
    probe = ContextGenerator.probe_batch
    encode = EmbeddingModel.encode_batch_device
    want = {"featurize": 0, "linucb": 0}

    def routing(self, queries, *args, **kwargs):
        if queries and self.config.algorithm == "linucb" and (
                self.config.solve_mode == "sherman_morrison"):
            want["linucb"] += 1
            ctx = self.context
            if self._device_featurize_active() and (
                    (ctx.use_cluster and kwargs.get("embeddings") is None)
                    or (ctx.use_task and kwargs.get("task_labels") is None)):
                want["featurize"] += 1
        return route(self, queries, *args, **kwargs)

    def probing(self, texts):
        if texts and self.device_active:
            want["featurize"] += 1
        return probe(self, texts)

    def encoding(self, texts, device):
        if len(texts):
            want["featurize"] += 1
        return encode(self, texts, device)

    GreenServRouter.route_batch = routing
    ContextGenerator.probe_batch = probing
    EmbeddingModel.encode_batch_device = encoding
    try:
        yield want
    finally:
        GreenServRouter.route_batch = route
        ContextGenerator.probe_batch = probe
        EmbeddingModel.encode_batch_device = encode


def bench_part(dev, tally) -> None:
    """The paper's remaining experiments through the port's benches, every
    router on the card with featurize "auto": Fig. 4 (``lambda_sweep``),
    Fig. 5 (``features``) and its ``--perf`` mode with parity, Fig. 6
    (``model_addition``), Tables 3–4 (``overhead``), ``prefill`` and
    ``energy_model`` with its MAE gate; each table printed, the router
    kernels' launches held to the routing calls of each bench."""
    from repro_torch.benchmarks import (energy_model, features, lambda_sweep,
                                        model_addition, overhead, prefill)

    runs = (       # (name, whether it routes, the bench's entry point)
        ("lambda_sweep", True, lambda: lambda_sweep.main(
            per_task=BENCH_SWEEP_PER_TASK, n_runs=BENCH_RUNS, device=dev)),
        ("features", True, lambda: features.main(
            per_task=BENCH_SWEEP_PER_TASK, n_runs=BENCH_RUNS, device=dev)),
        ("features --perf --smoke", True, lambda: features.perf_main(
            smoke=True, device=dev)),
        ("model_addition", True, lambda: model_addition.main(device=dev)),
        ("overhead", True, lambda: overhead.main(device=dev)),
        ("prefill", False, lambda: prefill.main(device=dev)),
        ("energy_model --smoke", True, lambda: energy_model.main(
            n_queries=BENCH_ENERGY_QUERIES, smoke=True, artifact=None,
            device=dev)))
    for name, routes, fn in runs:
        held_bench(name, routes, fn, tally)


def held_bench(name: str, routes: bool, fn, tally):
    """Run a bench's entry point with the router kernels' launches held to
    its routing calls (``router_launches``) and no other kernel launched;
    tally them, log its seconds and the lines it returns; returns what
    ``fn`` returns."""
    reset_launches()
    t = time.perf_counter()
    with router_launches() as want:
        lines = fn()
    torch.cuda.synchronize()
    got = read_launches()
    if ({k: got[k] for k in want} != want
            or bool(want["linucb"]) != routes
            or any(v for k, v in got.items() if k not in want)):
        raise AssertionError(f"bench {name}: launches {got}, expected "
                             f"{want}")
    tally(want)
    log("families", f"bench {name}: {time.perf_counter() - t:.2f} s, "
        f"router launches {want}")
    for line in lines if isinstance(lines, list) else ():
        log("families", f"  {line}")
    return lines


def equal_lines(what: str, got: list, want: list) -> None:
    if got != want:
        diff = [(g, w) for g, w in zip(got, want) if g != w]
        raise AssertionError(f"{what}: {len(got)} lines against the JAX "
                             f"package's {len(want)}; first differences "
                             f"{diff[:3]}")


def kernel_rows(dev) -> None:
    """``benchmarks/kernels.py``'s four rows on the card, each held to the
    kernel phase's tolerance for its kernel (flash and decode attention in
    bf16 at one bf16 unit, flash's tensor-core route plus the bound of
    carrying p as two bf16 parts; gating indices exact, weights
    ``GATING_TOL``; LinUCB ``LINUCB_TOL``).  Launches made to compare a
    kernel with its plain version: not counted."""
    from repro_torch.benchmarks import kernels
    from repro_torch.kernels.flash_attention import kernel as flash_kernel
    from repro_torch.kernels.flash_attention.ref import attention_ref

    t = time.perf_counter()
    rows = kernels.run(dev)
    for r in rows:
        name = f"kernels.main {r['kernel']},{r['config']}"
        if r["kernel"] in ("flash_attention", "decode_attention"):
            out, ref = r["out"].float(), r["ref"].float()
            rms = float(ref.pow(2).mean().sqrt())
            limit = FLASH_BF16_REL * (ref.abs() + rms)
            if r["kernel"] == "flash_attention" and flash_kernel.route(
                    torch.bfloat16, r["inputs"][0].shape[-1]) == "wgmma":
                q, k, v = (x.float() for x in r["inputs"])
                limit += FLASH_P_REL * attention_ref(q, k, v.abs(), 512)
            ratio = float(((out - ref).abs() / limit).max())
            ok, what = ratio <= 1, f"{ratio:.3g} of one bf16 unit"
        elif r["kernel"] == "moe_gating":
            ok = (torch.equal(r["out"][1], r["ref"][1])
                  and r["err"] <= GATING_TOL)
            what = f"indices equal, weights within {GATING_TOL}"
        else:
            ok, what = r["err"] <= LINUCB_TOL, f"within {LINUCB_TOL}"
        if not (ok and all(torch.isfinite(x).all() for x in (
                r["out"] if isinstance(r["out"], tuple) else (r["out"],))
                if x.is_floating_point())):
            raise AssertionError(f"{name}: max abs err {r['err']} ({what})")
        log("families", f"{name}: plain {r['ref_us']:.0f} us a call, max "
            f"abs err {r['err']:.3g} ({what})")
    del rows
    reset_launches()
    log("families", f"bench kernels: {time.perf_counter() - t:.2f} s")


def main_part(dev, tally) -> None:
    """(d) the benchmark entry points and the quickstart, every router on
    the card with featurize "auto": telemetry (the < 5% overhead assertion
    live, the governance lines == the JAX package's CPU record), the cache
    bench over the served granite at full width (its smoke assertions),
    baselines and RouterBench with ``--smoke`` (every line == the CPU
    record), the kernel rows, the quickstart example (its numbers == the
    reference script's)."""
    import importlib.util

    from repro_torch.benchmarks import baselines, cache, routerbench, telemetry

    lines = held_bench("telemetry --smoke", True, lambda: telemetry.main(
        per_task=MAIN_TEL_PER_TASK, smoke=True, device=dev), tally)
    equal_lines("telemetry governance",
                [l for l in lines if l.startswith("governance,")],
                TELEMETRY_JAX)

    granite = family_model(dev, "granite-3-8b", seed=0,
                           **SERVE_CUTS["granite-3-8b"])
    held_bench("cache --smoke", True, lambda: cache.main(
        n_queries=MAIN_CACHE_QUERIES, smoke=True, artifact=None,
        device=dev, weights={"granite-3-8b": granite}), tally)
    del granite
    gc.collect()
    torch.cuda.empty_cache()

    lines = held_bench("baselines --smoke", True, lambda: baselines.main(
        smoke=True, artifact=None, device=dev, **MAIN_BASELINES), tally)
    equal_lines("baselines", lines, BASELINES_JAX)
    lines = held_bench("routerbench --smoke", True, lambda: routerbench.main(
        smoke=True, artifact=None, device=dev, **MAIN_ROUTERBENCH), tally)
    equal_lines("routerbench", lines, ROUTERBENCH_JAX)

    kernel_rows(dev)

    spec = importlib.util.spec_from_file_location(
        "torch_quickstart", ROOT / "examples" / "torch_quickstart.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    out = held_bench("examples/torch_quickstart.py", True,
                     lambda: quickstart.main([]), tally)
    got = {"accuracy": f"{out['accuracy']:.3f}",
           "energy_wh": f"{out['energy_wh']:.1f}",
           "selections": out["selections"]}
    if got != QUICKSTART_JAX:
        raise AssertionError(f"quickstart: {got} against the reference "
                             f"script's {QUICKSTART_JAX}")
    log("families", f"quickstart: accuracy {got['accuracy']}, "
        f"{got['energy_wh']} Wh, {sum(got['selections'].values())} routed "
        f"over {len(got['selections'])} models: the reference's; "
        f"{out['decision_ms']:.3f} ms a decision")


def families_phase(dev) -> dict:
    """(a) whisper-medium, (b) gemma3-27b, llava-next-34b and grok-1-314b
    at full width, (c) the paper benches, (d) the benchmark entry points
    and the quickstart; each part's models freed before the next.  Returns
    every kernel's launches."""
    launches = dict.fromkeys(_ops_modules(), 0)

    def tally(got):
        for k, v in got.items():
            launches[k] += v

    for name, part in (("(a) whisper", lambda: tally(whisper_part(dev,
                                                                  tally))),
                       ("(b) gemma3-27b", lambda: [tally(x) for x in
                                                   gemma27_part(dev)
                                                   .values()]),
                       ("(b) llava", lambda: tally(llava_part(dev))),
                       ("(b) grok", lambda: tally(grok_part(dev))),
                       ("(c) benches", lambda: bench_part(dev, tally)),
                       ("(d) entry points", lambda: main_part(dev, tally))):
        t = time.perf_counter()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        log("families", f"{name}: {time.perf_counter() - t:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# 11. training on the card
# ---------------------------------------------------------------------------


def train_full_width(dev, lr: float = TRAIN_FULL[3]) -> tuple:
    """(a) ``make_train_step`` at rwkv6-1.6b's full width and depth on
    ``synthetic_batches``, at ``lr``: no kernel launched.  Returns (model,
    cfg, losses, grad norms, {"ms": the median ms a step, "peak": peak
    bytes above the start}); ``train_phase`` checks them."""
    from repro_torch import train as tr
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import api, convert

    b, s, steps, _ = TRAIN_FULL
    cfg = get_config(RWKV_ARCH)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    model = api.init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    ocfg = tr.OptConfig(lr=lr, total_steps=steps,
                        warmup_steps=min(20, steps // 5 + 1),
                        moment_dtype=cfg.moment_dtype)
    data = synthetic_batches(cfg, b, s + 1, device=dev)
    bundle = tr.make_train_step(cfg, _card_mesh(dev), next(data), ocfg,
                                loss_chunk=min(512, s))
    opt = tr.make_opt_state(cfg, model, ocfg)
    reset_launches()
    losses, norms, ms = [], [], []
    for _ in range(steps):
        batch = next(data)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model, opt, m = bundle.fn(model, opt, batch)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    launched = {k: v for k, v in read_launches().items() if v}
    peak = torch.cuda.max_memory_allocated() - base
    med = float(np.median(ms[1:]))
    state = sum(p.numel() * p.element_size() for p in model.parameters())
    state += sum(t.numel() * t.element_size()
                 for key in ("m", "v")
                 for _, t in convert.tree_items(opt[key]))
    log("train", f"(a) {RWKV_ARCH} full width ({n_params / 1e9:.3f} B "
        f"parameters, {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}), B={b} S={s}, {steps} steps at "
        f"lr {lr}: loss {losses[0]:.4f} -> {losses[-1]:.4f}, grad norm "
        f"{norms[0]:.3f} -> {norms[-1]:.3f}; median {med:.3f} ms a step "
        f"(steps 2-{steps}; first {ms[0]:.1f} ms; the weights drawn in "
        f"{t_init:.2f} s), "
        f"{b * s / med * 1e3:.1f} tokens/s; peak memory {peak / 2**30:.2f} "
        f"GiB above {base / 2**30:.2f}, parameters + moments "
        f"{state / 2**30:.2f} GiB (+ gradients {n_params * 4 / 2**30:.2f})")
    log("train", "(a) losses " + " ".join(f"{x:.4f}" for x in losses))
    if launched:
        raise AssertionError(f"(a) training launched kernels: {launched}")
    del opt
    return model, cfg, losses, norms, {"ms": med, "peak": peak}


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def train_parity(dev) -> None:
    """(b) the same weights and batches through ``make_train_step`` on the
    card and on the CPU: losses, lr and grad norms, then every parameter
    leaf, at the CPU tests' tolerances; ``ef_compress`` and
    ``compressed_psum`` bit-equal."""
    from repro_torch import train as tr
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import api, convert

    cpu = torch.device("cpu")
    b, s, steps, lr = TRAIN_PARITY
    for arch in TRAIN_PARITY_ARCHS:
        cfg = get_config(arch, smoke=True, dtype="float32")
        tree = convert.params_to_jax(api.init_params(cfg, 1, cpu), cfg)
        runs = []
        for d in (dev, cpu):
            model = convert.params_from_jax(tree, cfg, d)
            ocfg = tr.OptConfig(lr=lr, total_steps=10, warmup_steps=1)
            data = synthetic_batches(cfg, b, s, device=d)
            bundle = tr.make_train_step(cfg, _card_mesh(d), next(data),
                                        ocfg, loss_chunk=16)
            opt = tr.make_opt_state(cfg, model, ocfg)
            metrics = []
            for _ in range(steps):
                model, opt, m = bundle.fn(model, opt, next(data))
                metrics.append({k: float(v) for k, v in m.items()})
            runs.append((metrics, convert.params_to_jax(model, cfg)))
        (got_m, got_p), (want_m, want_p) = runs
        gap = {k: max(abs(g[k] - w[k]) / abs(w[k]) if w[k] else abs(g[k])
                      for g, w in zip(got_m, want_m))
               for k in ("loss", "lr", "grad_norm")}
        worst_p = max((_rel_l2(convert.tree_get(got_p, path), leaf), path)
                      for path, leaf in convert.tree_items(want_p))
        log("train", f"(b) {arch} smoke fp32, {steps} steps on the card vs "
            f"the CPU: losses {[round(m['loss'], 6) for m in got_m]}; "
            f"largest relative gap of the loss {gap['loss']:.3g}, lr "
            f"{gap['lr']:.3g}, grad norm {gap['grad_norm']:.3g}; of a "
            f"parameter leaf (L2) {worst_p[0]:.3g} "
            f"({'/'.join(worst_p[1])})")
        if not (gap["loss"] <= TRAIN_LOSS_REL
                and worst_p[0] <= TRAIN_PARAM_REL):
            raise AssertionError(f"(b) {arch}: card vs CPU {gap['loss']:.3g}"
                                 f" / {worst_p[0]:.3g} > {TRAIN_LOSS_REL} / "
                                 f"{TRAIN_PARAM_REL}")
    rng = np.random.default_rng(0)
    ef = [tr.ef_init({"w": torch.zeros(64, device=d),
                      "m": torch.zeros(3, 5, 7, device=d)})
          for d in (dev, cpu)]
    for i in range(30):
        g = {"w": rng.standard_normal(64).astype(np.float32),
             "m": rng.standard_normal((3, 5, 7)).astype(np.float32) * i}
        out = []
        for j, d in enumerate((dev, cpu)):
            gq, ef[j] = tr.ef_compress(
                {k: torch.from_numpy(v).to(d) for k, v in g.items()}, ef[j])
            out.append((gq, ef[j]))
        for k in g:
            for a, c in zip(*out):
                if not torch.equal(a[k].cpu(), c[k]):
                    raise AssertionError(f"(b) ef_compress step {i} {k}: "
                                         f"card != CPU")
    stacked = {"w": torch.from_numpy(rng.standard_normal((8, 32, 16))
                                     .astype(np.float32))}
    mesh = make_mesh((8,), ("data",))
    sums = [tr.compressed_psum({k: v.to(d) for k, v in stacked.items()},
                               "data", mesh)["w"].cpu() for d in (dev, cpu)]
    if not torch.equal(*sums):
        raise AssertionError("(b) compressed_psum: card != CPU")
    log("train", "(b) ef_compress over 30 steps and compressed_psum over 8 "
        "replicas bit-equal, card vs CPU")


def train_launcher(dev) -> None:
    """(c) the launcher with an injected failure (tests/test_train.py's
    call) and the ``torch_train_100m`` example twin at its defaults, on
    the card."""
    import importlib.util
    import tempfile

    from repro_torch.launch.train import train

    with tempfile.TemporaryDirectory() as d:
        out = train(RWKV_ARCH, smoke=True, ckpt_dir=d, log_every=100,
                    device=dev, **TRAIN_LAUNCHER)
    log("train", f"(c) launcher: {out['steps']} steps, {len(out['losses'])} "
        f"losses (the restored span re-run), {out['first_loss']:.4f} -> "
        f"{out['final_loss']:.4f}")
    if not (out["steps"] == TRAIN_LAUNCHER["steps"]
            and np.isfinite(out["final_loss"])
            and len(out["losses"]) >= TRAIN_LAUNCHER["steps"]):
        raise AssertionError(f"(c) launcher: {out}")
    spec = importlib.util.spec_from_file_location(
        "torch_train_100m", ROOT / "examples" / "torch_train_100m.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = twin.main(["--ckpt", d])
    log("train", f"(c) examples/torch_train_100m.py: {out['steps']} steps, "
        f"loss {out['first_loss']:.4f} -> {out['final_loss']:.4f} in "
        f"{time.perf_counter() - t:.2f} s")
    if not out["final_loss"] < out["first_loss"]:
        raise AssertionError(f"(c) the twin's loss did not fall: {out}")


def _psum_replicas() -> dict:
    """(e2)'s 8 replicas of a (32, 16) gradient."""
    rng = np.random.default_rng(0)
    return {"w": torch.from_numpy(rng.standard_normal((8, 32, 16))
                                  .astype(np.float32))}


def _card_mesh(dev):
    """The ("data", "model") mesh of (1, 1) on ``dev``, whatever the host
    holds: the one-card checks' mesh (outside a process group,
    ``make_host_mesh`` refuses a host of more than one card)."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh((1, 1), ("data", "model"), dev.type)


def _smoke_steps(arch: str, mesh, dev, n_micro: int = 1) -> tuple:
    """``arch``'s smoke config in fp32 with error feedback through
    ``make_train_step`` on ``mesh``, at TRAIN_PARITY's batch, steps and
    lr, the weights of seed 1.  Returns (losses, grad norms, the
    parameters on the CPU after the first step and after the last)."""
    from repro_torch import train as tr
    from repro_torch.configs import get_config
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import api, convert

    b, s, steps, lr = TRAIN_PARITY
    cfg = get_config(arch, smoke=True, dtype="float32")
    tree = convert.params_to_jax(api.init_params(cfg, 1, "cpu"), cfg)
    model = convert.params_from_jax(tree, cfg, dev)
    ocfg = tr.OptConfig(lr=lr, total_steps=10, warmup_steps=1)
    data = synthetic_batches(cfg, b, s, device=dev)
    bundle = tr.make_train_step(cfg, mesh, next(data), ocfg, loss_chunk=16,
                                n_micro=n_micro, use_ef_compress=True)
    opt = tr.make_opt_state(cfg, model, ocfg, True)
    losses, norms, states = [], [], []
    for i in range(steps):
        model, opt, m = bundle.fn(model, opt, next(data))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i in (0, steps - 1):
            states.append({"/".join(path): leaf.detach().cpu()
                           for path, leaf in convert.tree_items(
                               convert.params_to_jax(model, cfg))})
    return losses, norms, states


def _same_steps(a: tuple, b: tuple) -> bool:
    """Two ``_smoke_steps`` results, bit for bit."""
    return a[0] == b[0] and a[1] == b[1] and all(
        torch.equal(x[k], y[k]) for x, y in zip(a[2], b[2]) for k in x)


def _steps_gaps(got: tuple, want: tuple) -> tuple:
    """The largest relative gap of a loss and of a grad norm over the
    steps, and of a parameter leaf (L2) after the first step and after
    the last (with the leaf's name)."""
    rel = lambda x, y: abs(x - y) / abs(y)  # noqa: E731
    return (max(map(rel, got[0], want[0])), max(map(rel, got[1], want[1])),
            [max((_rel_l2(g[k], leaf), k) for k, leaf in w.items())
             for g, w in zip(got[2], want[2])])


def _ranks_job(r) -> dict:
    """(e2) one rank of the group: each smoke config's steps on the
    (world, 1) mesh of ranks, then ``compressed_psum`` on this rank's
    block of the 8 replicas."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import compressed_psum

    mesh = make_host_mesh(r.device)
    out = {arch: _smoke_steps(arch, mesh, r.device) for arch in TRAIN_RANKS}
    n = 8 // r.world
    block = {k: v[r.rank * n:(r.rank + 1) * n].to(r.device)
             for k, v in _psum_replicas().items()}
    out["psum"] = compressed_psum(block, "data", mesh)["w"].cpu()
    return out


def train_ranks(dev, want_losses: list, want_norms: list,
                figures: dict) -> None:
    """(e) training over the ranks of a process group.  (e1) one rank in
    this process on its card, over NCCL: ``launch.train.train`` at (a)'s
    model, batch, lr and steps, its losses and grad norms bit-equal to
    (a)'s (a one-rank all-reduce and a division by 1 are exact); its ms a
    step, the mean over the ranks' ms a step (CUDA events) and its peak
    memory beside (a)'s.  (e2) two spawned ranks driving the one card over
    gloo (NCCL takes one rank a device): smoke rwkv6 and qwen2-moe in fp32
    with error feedback (TRAIN_RANKS), the ranks bit-equal, against this
    process's step on the whole batch — at n_micro 2, the ranks' rows a
    microbatch, every loss, grad norm and the parameters after the first
    step and the last at TRAIN_LOSS_REL / TRAIN_PARAM_REL; at n_micro 1
    at TRAIN_RANKS_WHOLE — and ``compressed_psum`` over 2 ranks × 4
    replicas bit-equal to the one-device form."""
    import tempfile

    from repro_torch.distributed import ranks
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.train import compressed_psum
    from repro_torch.train import step as train_step

    b, s, steps, lr = TRAIN_FULL
    cuda = dev.type == "cuda"       # else a rehearsal on the CPU
    # the mean over the ranks timed between CUDA events: no host sync
    events = []
    mean_over_ranks = train_step._mean_over_ranks

    def timed(tensors, mesh):
        if not cuda:
            return mean_over_ranks(tensors, mesh)
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = mean_over_ranks(tensors, mesh)
        pair[1].record()
        events.append(pair)
        return out

    t = time.perf_counter()
    train_step._mean_over_ranks = timed
    try:
        with tempfile.TemporaryDirectory() as d:
            # one rank, this process, on its card (NCCL takes one rank a
            # device, so one process is one rank on any host)
            with ranks.joined(dev, rank=0, world=1,
                              backend="nccl" if cuda else "gloo",
                              init_method=f"file://{d}/rendezvous") as r:
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = train(RWKV_ARCH, smoke=False, steps=steps, batch=b,
                            seq=s, ckpt_dir=None, lr=lr, log_every=steps,
                            device=dev)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated() - base
    finally:
        train_step._mean_over_ranks = mean_over_ranks
    med = float(np.median(out["step_ms"][1:]))
    reduce_ms = [a.elapsed_time(z) for a, z in events] or [0.0] * steps
    log("train", f"(e1) {RWKV_ARCH} full width through launch.train.train "
        f"on the (1, 1) mesh of ranks, rank {r.rank} of {r.world} on "
        f"{r.device} over {r.backend}, B={b} S={s}, {out['steps']} steps "
        f"at lr {lr}: loss {out['losses'][0]:.4f} -> "
        f"{out['losses'][-1]:.4f}; median {med:.3f} ms a step (steps "
        f"2-{steps}, host clock, data drawn inside; (a) "
        f"{figures['ms']:.3f}), of it the mean of the gradients and the "
        f"loss over the ranks {float(np.median(reduce_ms[1:])):.3f} ms "
        f"(CUDA events, steps 2-{steps}: "
        f"{' '.join(f'{x:.3f}' for x in reduce_ms[1:])}); peak memory "
        f"{peak / 2**30:.2f} GiB above {base / 2**30:.2f} ((a) "
        f"{figures['peak'] / 2**30:.2f}); {time.perf_counter() - t:.2f} s")
    if not (out["steps"] == steps and out["losses"] == want_losses
            and out["grad_norms"] == want_norms):
        raise AssertionError(f"(e1) the rank path's losses / grad norms "
                             f"{out['losses']} / {out['grad_norms']} are "
                             f"not (a)'s {want_losses} / {want_norms}")
    log("train", f"(e1) all {steps} losses and grad norms bit-equal to "
        f"(a)'s")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    t = time.perf_counter()
    card = torch.device("cuda", 0) if cuda else dev
    if cuda:
        free, total = torch.cuda.mem_get_info()
        log("train", f"(e2) before the ranks start: {free / 2**30:.2f} of "
            f"{total / 2**30:.2f} GiB free on the card, this process "
            f"holding {torch.cuda.memory_reserved() / 2**30:.2f}")
    got = ranks.spawn(_ranks_job, 2, device=card, backend="gloo",
                      timeout=300)
    t_ranks = time.perf_counter() - t
    mesh = _card_mesh(dev)
    for arch in TRAIN_RANKS:
        mine = got[0][arch]
        split = _steps_gaps(mine, _smoke_steps(arch, mesh, dev, n_micro=2))
        whole = _steps_gaps(mine, _smoke_steps(arch, mesh, dev))
        same = _same_steps(mine, got[1][arch])
        loss_rel, param_rel = TRAIN_RANKS_WHOLE[arch]
        said = [f"losses {g[0]:.3g}, grad norms {g[1]:.3g}, a parameter "
                f"leaf (L2) after the first step {g[2][0][0]:.3g} "
                f"({g[2][0][1]}) and the last {g[2][1][0]:.3g} "
                f"({g[2][1][1]})" for g in (split, whole)]
        log("train", f"(e2) {arch} smoke fp32 with error feedback, 2 ranks "
            f"on {card} over gloo (NCCL takes one rank a device), "
            f"{TRAIN_PARITY[2]} steps: losses "
            f"{[round(x, 6) for x in mine[0]]}; the ranks bit-equal: "
            f"{same}; largest relative gaps to this process's step on the "
            f"whole batch at n_micro 2 (the ranks' rows a microbatch): "
            f"{said[0]}; at n_micro 1: {said[1]}")
        if not (same and split[0] <= TRAIN_LOSS_REL
                and split[1] <= TRAIN_LOSS_REL
                and all(w <= TRAIN_PARAM_REL for w, _ in split[2])):
            raise AssertionError(
                f"(e2) {arch}: 2 ranks vs one process at n_micro 2 "
                f"{split} > {TRAIN_LOSS_REL} / {TRAIN_PARAM_REL}, or the "
                f"ranks differ ({same})")
        if not (whole[0] <= loss_rel
                and all(w <= param_rel for w, _ in whole[2])):
            raise AssertionError(
                f"(e2) {arch}: 2 ranks vs one process at n_micro 1 "
                f"{whole} > {loss_rel} / {param_rel}")
    one = compressed_psum({k: v.to(dev) for k, v in
                           _psum_replicas().items()}, "data",
                          make_mesh((8,), ("data",)))["w"].cpu()
    if not all(torch.equal(g["psum"], one) for g in got):
        raise AssertionError("(e2) compressed_psum over 2 ranks x 4 "
                             "replicas != the one-device form")
    log("train", f"(e2) compressed_psum over 2 ranks x 4 replicas bit-equal "
        f"to the one-device form; the two ranks took {t_ranks:.2f} s "
        f"(process start included), the part {time.perf_counter() - t:.2f} "
        f"s")


def train_handoff(dev, model, cfg) -> dict:
    """(d) (a)'s trained parameters written as a checkpoint through
    ``params_to_jax``, restored into a serving model and prefilled with
    ``use_pallas=True``: one WKV launch a layer and no other, the logits
    against the same model's ``use_pallas=False`` path (checked at the
    first PREFILL_CHECK_DEPTH layers, as the prefill phase's; printed at
    full depth); a kernel wrapper refusing a grad-requiring input.
    Returns the prefill's launches."""
    import tempfile

    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.kernels.rwkv6 import ops as rwkv6_ops
    from repro_torch.launch.train import synthetic_batches
    from repro_torch.models import api, convert, lm

    serve_cfg = dataclasses.replace(cfg, use_pallas=True)
    tree = convert.params_to_jax(model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        ckpt.save(d, TRAIN_FULL[2], tree, extra={"arch": RWKV_ARCH})
        t_save = time.perf_counter() - t
        t = time.perf_counter()
        shapes = api.param_shapes(cfg)
        restored, _ = ckpt.restore(d, shapes, shardings=convert.tree_map(
            lambda _: dev, shapes))
        serving = convert.load_params_(lm.DecoderLM(serve_cfg, dev),
                                       restored)
        t_load = time.perf_counter() - t
    del restored
    for path, idx, p in convert.jax_paths(serving):
        leaf = convert.tree_get(tree, path)
        if not torch.equal(p, leaf if idx is None else leaf[idx]):
            raise AssertionError(f"(d) {'/'.join(path)}[{idx}] changed "
                                 f"through the checkpoint")
    del tree
    torch.cuda.empty_cache()
    toks = next(synthetic_batches(cfg, 1, HANDOFF_S + 1, seed=7,
                                  device=dev))["tokens"]
    batch = {"tokens": toks}
    reset_launches()
    fast = api.prefill(serving, batch, serve_cfg)
    torch.cuda.synchronize()
    launches = read_launches()
    want = expected_launches(serve_cfg)
    plain = api.prefill(serving, batch,
                        dataclasses.replace(serve_cfg, use_pallas=False))
    full = logit_gap(fast, plain)
    view, cut = layers_view(serving, serve_cfg, range(PREFILL_CHECK_DEPTH))
    gap = logit_gap(api.prefill(view, batch, cut), api.prefill(
        view, batch, dataclasses.replace(cut, use_pallas=False)))
    log("train", f"(d) checkpoint of the trained {RWKV_ARCH} written in "
        f"{t_save:.2f} s, restored into a serving model in {t_load:.2f} s, "
        f"every parameter bit-equal; prefill B=1 S={HANDOFF_S} launches "
        f"{launches}; use_pallas True vs False: {gap[0]:.5f} of the logit "
        f"range at {PREFILL_CHECK_DEPTH} layers (mean {gap[1]:.5f}), "
        f"{full[0]:.5f} at {cfg.n_layers} (mean {full[1]:.5f})")
    if launches != want:
        raise AssertionError(f"(d) prefill launches {launches}, expected "
                             f"{want}")
    if not (torch.isfinite(fast).all() and gap[0] <= PREFILL_REL_TOL):
        raise AssertionError(f"(d) use_pallas True vs False {gap[0]:.5f} > "
                             f"{PREFILL_REL_TOL} of the logit range, or "
                             f"logits not finite")
    q = torch.randn((1, 8, 2, 64), device=dev, requires_grad=True)
    n0 = rwkv6_ops.launches
    try:
        rwkv6_ops.wkv(q, q, q, -torch.ones_like(q), torch.zeros(
            (2, 64), device=dev))
    except RuntimeError as e:
        if "no backward pass" not in str(e):
            raise
    else:
        raise AssertionError("(d) the WKV wrapper took a grad-requiring "
                             "input under grad mode")
    if rwkv6_ops.launches != n0:
        raise AssertionError("(d) the refused call launched the kernel")
    log("train", "(d) the WKV wrapper refuses a grad-requiring input under "
        "grad mode, on the card, without a launch")
    return launches


def train_phase(dev) -> dict:
    """(a) full-width training, (b) card == CPU, (c) the launcher and the
    example twin, (d) the hand-off to serving.  Returns (d)'s launches
    (training itself launches none)."""
    t = time.perf_counter()
    model, cfg, losses, norms, figures = train_full_width(dev)
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"(a) a loss or grad norm is not finite: "
                             f"{losses} {norms}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"(a) the last loss {losses[-1]} is not below "
                             f"the first {losses[0]}")
    log("train", f"(a) {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    launches = train_handoff(dev, model, cfg)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log("train", f"(d) {time.perf_counter() - t:.2f} s")
    for name, part in (("(b)", train_parity), ("(c)", train_launcher),
                       ("(e)", lambda d: train_ranks(d, losses, norms,
                                                     figures))):
        t = time.perf_counter()
        reset_launches()
        part(dev)
        launched = {k: v for k, v in read_launches().items() if v}
        if launched:
            raise AssertionError(f"{name} training launched kernels: "
                                 f"{launched}")
        log("train", f"{name} {time.perf_counter() - t:.2f} s")
    return launches


# ---------------------------------------------------------------------------
# 12. the cost walk on the card
# ---------------------------------------------------------------------------


def step_ms(dev, fn, reps: int = COST_REPS) -> float:
    """The median milliseconds of ``reps`` calls of ``fn`` after one
    warm-up, each between two CUDA events (host clock off the card)."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
    return float(np.median(times))


def cost_cell(dev, model, cfg, b: int, s: int, kind: str, out_dir) -> tuple:
    """One card cell: its meta record (written to ``out_dir``), the FLOP
    count of the real step on the card against it, and the step timed
    with ``use_pallas`` False and True.  Returns (record, launches)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import train as tr
    from repro_torch.configs import ShapeCell
    from repro_torch.core.energy import HBM_BW
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api

    cell = ShapeCell(f"card_{kind}_b{b}_s{s}", kind, s, b)
    t = time.perf_counter()
    rec = dryrun.run_cell(COST_ARCH, cell, mesh=make_mesh(
        (1, 1), ("data", "model")), lockstep=True)
    t_walk = time.perf_counter() - t
    (out_dir / f"{COST_ARCH}__{cell.name}__1x1.json").write_text(
        json.dumps(rec, indent=1))
    mesh = _card_mesh(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    if kind == "prefill":
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=gen, device=dev,
                                         dtype=torch.int32)}

        def bundle(c):
            return tr.make_prefill_step(c, mesh, batch)

        def call(bd):
            return bd.fn(model, batch)
    else:
        cache = api.init_cache(cfg, b, s, dev)
        cache["length"] = torch.tensor(s - 4 * COST_REPS - 8,
                                       dtype=torch.int32, device=dev)
        token = torch.randint(0, cfg.vocab_size, (b, 1), generator=gen,
                              device=dev, dtype=torch.int32)

        def bundle(c):
            return tr.make_serve_step(c, mesh, b, s)

        def call(bd):
            return bd.fn(model, cache, token)
    plain = bundle(cfg)
    fast = bundle(dataclasses.replace(cfg, use_pallas=True))
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as counter:
        call(plain)
    flops = counter.get_total_flops()
    torch.cuda.synchronize()
    ms_plain = step_ms(dev, lambda: call(plain))
    reset_launches()
    ms_fast = step_ms(dev, lambda: call(fast))
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    peak = torch.cuda.max_memory_allocated()
    floor_s = max(rec["t_compute_s"], rec["arg_bytes_per_dev"] / HBM_BW)
    log("cost", f"{kind} B={b} S={s}: the meta walk {t_walk:.2f} s "
        f"(record {rec['walk_s']} s); FLOPs on the card {flops:,} == the "
        f"record's {int(rec['flops']):,}: {flops == rec['flops']}; "
        f"{ms_plain:.3f} ms (use_pallas=False), {ms_fast:.3f} ms "
        f"(use_pallas=True, launches {launches} over {COST_REPS + 1} "
        f"calls) against t_compute {rec['t_compute_s'] * 1e3:.3f} ms, "
        f"t_memory (eager bytes {rec['bytes_per_dev']:.4g}) "
        f"{rec['t_memory_s'] * 1e3:.3f} ms, bottleneck "
        f"{rec['bottleneck']}, the floor {floor_s * 1e3:.3f} ms (arg bytes "
        f"{rec['arg_bytes_per_dev']:,}); max_memory_allocated "
        f"{peak / 2**30:.2f} GiB beside peak_bytes_per_dev "
        f"{rec['peak_bytes_per_dev'] / 2**30:.2f} GiB (temp "
        f"{rec['temp_bytes_per_dev'] / 2**30:.2f})")
    if flops != rec["flops"]:
        raise AssertionError(f"(b) {kind}: {flops} FLOPs on the card, "
                             f"{rec['flops']} in the meta record")
    for what, ms in (("use_pallas=False", ms_plain),
                     ("use_pallas=True", ms_fast)):
        if ms / 1e3 < floor_s / COST_SLACK:
            raise AssertionError(f"(c) {kind} {what}: {ms:.3f} ms under "
                                 f"the floor {floor_s * 1e3:.3f} ms / "
                                 f"{COST_SLACK}")
    want = {"flash_attention" if kind == "prefill" else "decode_attention":
            cfg.n_layers * (COST_REPS + 1)}
    if launches != want:
        raise AssertionError(f"(c) {kind} launches {launches}, expected "
                             f"{want}")
    return rec, launches


def cost_phase(dev) -> dict:
    """(a)–(d) on full-width granite-3-8b: two one-card records, the card's
    FLOPs equal to them, the steps above their spec floors, the Roofline
    table.  Returns the kernels' launches."""
    import tempfile

    from repro_torch.benchmarks import roofline
    from repro_torch.configs import for_mode, get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import api

    name = torch.cuda.get_device_name(0)
    total = torch.cuda.get_device_properties(0).total_memory
    log("cost", f"{name}: total_memory {total:,} B; dryrun.HBM_PER_CHIP "
        f"{dryrun.HBM_PER_CHIP:,}")
    if "H100 80GB HBM3" in name and total != dryrun.HBM_PER_CHIP:
        raise AssertionError(f"(a) HBM_PER_CHIP {dryrun.HBM_PER_CHIP} is "
                             f"not this {name}'s {total}")
    cfg = for_mode(get_config(COST_ARCH), "serve")
    t = time.perf_counter()
    model = api.init_params(cfg, 0, dev)
    torch.cuda.synchronize()
    log("cost", f"{COST_ARCH} at full width and depth ({cfg.n_layers} "
        f"layers, {sum(p.numel() for p in model.parameters()) / 1e9:.3f} B "
        f"parameters, bf16) drawn in {time.perf_counter() - t:.2f} s")
    launches: dict = {}
    with tempfile.TemporaryDirectory() as d:
        out = Path(d)
        for b, s, kind in COST_CELLS:
            _, got = cost_cell(dev, model, cfg, b, s, kind, out)
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            gc.collect()
            torch.cuda.empty_cache()
        lines = roofline.table(str(out))
    for line in lines:
        log("cost", f"(d) {line}")
    status = [line.split(",")[3] for line in lines[1:]]
    if status != ["OK"] * len(COST_CELLS):
        raise AssertionError(f"(d) the Roofline table's rows: {status}")
    del model
    return launches


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

    print(card_line(), flush=True)
    log("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    log("build", f"kernels built and loaded in {time.perf_counter() - t0:.2f} s")

    t_start = time.perf_counter()
    t = time.perf_counter()
    sass = start_sass()
    try:
        feat = featurize_phase(dev)
        lin = linucb_phase(dev)
        gate = gating_phase(dev)
        flash = flash_phase(dev)
        wkv = wkv_phase(dev)
        ssd = ssd_phase(dev)
        decode = decode_phase(dev)
        scan_sass(sass)
    finally:
        if sass is not None and sass.poll() is None:
            sass.kill()
            sass.communicate()
    phase_done("kernels", t)
    t = time.perf_counter()
    router_phase(dev)
    phase_done("router", t)
    t = time.perf_counter()
    paper = paper_phase(dev)
    gc.collect()                  # the phase's routers and servers
    torch.cuda.empty_cache()
    phase_done("paper", t)
    t = time.perf_counter()
    launches, engines = serving_phase(dev)
    phase_done("serve", t)
    t = time.perf_counter()
    cached, cache_off_joules = cache_phase(dev, engines)
    phase_done("cache", t)
    t = time.perf_counter()
    energy = energy_phase(dev, engines, cache_off_joules)
    phase_done("energy", t)
    t = time.perf_counter()
    resilience = resilience_phase(dev, engines)
    phase_done("resilience", t, f"; launches {resilience}")
    t = time.perf_counter()
    fleet = fleet_phase(dev, engines)
    phase_done("fleet", t, f"; launches {fleet}")
    t = time.perf_counter()
    prefill = prefill_phase(dev, engines)
    del engines
    torch.cuda.empty_cache()
    phase_done("prefill", t)
    t = time.perf_counter()
    hybrid = hybrid_phase(dev)
    torch.cuda.empty_cache()
    phase_done("hybrid", t)
    t = time.perf_counter()
    gemma3 = gemma3_phase(dev)
    torch.cuda.empty_cache()
    phase_done("gemma3", t)
    t = time.perf_counter()
    engine_crosscheck(dev)
    phase_done("crosscheck", t)
    gc.collect()                  # every earlier phase's models
    torch.cuda.empty_cache()
    t = time.perf_counter()
    families = families_phase(dev)
    phase_done("families", t, f"; launches {families}")
    gc.collect()                  # the families' models
    torch.cuda.empty_cache()
    t = time.perf_counter()
    trained = train_phase(dev)
    phase_done("train", t, f"; launches {trained}")
    gc.collect()                  # the train phase's models
    torch.cuda.empty_cache()
    t = time.perf_counter()
    cost = cost_phase(dev)
    phase_done("cost", t, f"; launches {cost}")
    phase_done("total", t_start, " after the build")

    # the router kernels' rows are at Q = 1, LinUCB's at the paper pool's
    # M = 32, where most of their launches fall (their launches: serving's
    # admission batches of one at M = 4 and the paper phase's at M = 32
    # and RouterBench's M = 16); the MoE decode ticks gate T = 4 rows.  The
    # flash row is granite's one-shot prefill (B = 2, S = 2048), the WKV row
    # rwkv6's (B = 2, S = 2048), the SSD row zamba2's (B = 1, S = 4096);
    # their launches are the one-shot prefills' (flash: the four served
    # models', zamba2's 13 sites and gemma3's 48 layers).  The decode
    # attention row is gemma3's global layers in lockstep decode (B = 4,
    # cache_len 32705 of 32768), its launches those of the 32 steps
    # the families phase adds whisper's, llava's, gemma3-27b's and grok's
    # flash launches, grok's gating launches, gemma3-27b's decode
    # launches and the paper benches' router launches to each count, and
    # the train phase its hand-off prefill's WKV launches (training itself
    # launches none); the cost phase adds its prefills' flash launches and
    # its lockstep steps' decode launches
    f1 = next(r for r in feat["rows"] if r["label"] == "mode=both Q=1")
    l1 = next(r for r in lin["rows"] if r["label"] == "M=32 d=12 Q=1")
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
            launches["featurize"] + paper["featurize"] + cached["featurize"]
            + energy["featurize"] + resilience["featurize"]
            + fleet["featurize"] + families["featurize"], feat["worst"], f1),
        row("linucb", "linucb.cu", "linucb/kernel.py:25",
            launches["linucb"] + paper["linucb"] + cached["linucb"]
            + energy["linucb"] + resilience["linucb"] + fleet["linucb"]
            + families["linucb"], lin["worst"], l1),
        row("moe_gating", "moe_gating.cu", "moe_gating/kernel.py:23",
            launches["moe_gating"] + cached["moe_gating"]
            + energy["moe_gating"] + resilience["moe_gating"]
            + fleet["moe_gating"] + families["moe_gating"], gate["worst"],
            g4),
        row("flash_attention", "flash_attention.cu",
            "flash_attention/kernel.py:33",
            prefill["flash_attention"] + hybrid["flash_attention"]
            + gemma3["prefill"]["flash_attention"]
            + families["flash_attention"] + cost.get("flash_attention", 0),
            flash["worst"], fa, fa["library_ms"]),
        row("rwkv6", "rwkv6.cu", "rwkv6/kernel.py:25",
            prefill["rwkv6"] + trained["rwkv6"], wkv["worst"],
            wkv["rows"][0]),
        row("mamba2", "mamba2.cu", "mamba2/kernel.py:25", hybrid["mamba2"],
            ssd["worst"], ssd["rows"][0]),
        row("decode_attention", "decode_attention.cu",
            "decode_attention/kernel.py:29",
            gemma3["decode"]["decode_attention"]
            + families["decode_attention"]
            + cost.get("decode_attention", 0), decode["worst"], da,
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
