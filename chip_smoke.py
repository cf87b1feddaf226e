#!/usr/bin/env python3
"""Drive the PyTorch port of GreenServ on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card's name and power limit (nvidia-smi);
  2. build the router's CUDA kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels: featurize and LinUCB against their plain PyTorch versions on
     the card (featurize 1e-5, LinUCB 1e-4), timed with CUDA events;
  4. router: one 64-query stream through twin routers on the card, device
     featurize vs host featurize — arms, labels, clusters and bins must be
     identical;
  5. serving: ``PoolServer`` over two full-width dense engines
     (granite-3-8b, h2o-danube-3-4b; bf16, random weights from a seed) on
     a synthetic query stream plus a decode slice of short prompts — every
     query answered, finite logits, both kernels launched by the main
     path, real decode work — with three windows of the run under
     torch.profiler for the card's busy share and the top kernels;
  6. engine cross-check: two full-width granite layers, bf16 against fp32
     on the same weights.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero without a result when no
CUDA device is visible or the package is not beside this script.
"""
from __future__ import annotations

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
# bf16 vs fp32 logits of the same two layers, as a share of the fp32 logit
# range.  bf16 keeps 8 significant bits (unit roundoff 2^-9), but with the
# reference's init rule q and k reach magnitudes of 10-20 at d_model 4096,
# so attention scores are O(100) and the softmax is nearly one-hot: one
# bf16 rounding of q or k (about one unit of score) can shift weight
# between keys and move a logit by several percent of the range.  The
# check exists to catch a broken bf16 path (garbage or NaN: errors of the
# order of the range itself), so it allows a quarter of the range.
BF16_REL_TOL = 0.25
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32, outside the tensor cores
SERVE_ARCHS = ("granite-3-8b", "h2o-danube-3-4b")
PROFILE_STEPS = 5              # scheduler steps per profiled window


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, n: int = 200) -> float:
    """Mean milliseconds per call of ``fn`` over ``n`` back-to-back calls,
    between two CUDA events, after a warm-up."""
    for _ in range(5):
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


def bound(n_bytes: float, n_ops: float) -> tuple:
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# ---------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------


def featurize_phase(dev) -> dict:
    from repro_torch.core.context import ContextGenerator
    from repro_torch.core.types import RouterConfig
    from repro_torch.data.stream import make_stream
    from repro_torch.kernels.featurize import kernel, ops
    from repro_torch.kernels.featurize.ref import hashed_embed_ref

    ctx = ContextGenerator(RouterConfig(), device=dev)
    proj = ctx.embedder.proj_device(dev)
    stream = [q.text for q in make_stream(per_task=13, seed=21)]
    rows, worst = [], 0.0
    for mode in ("both", "full"):
        for q in (1, 16, 64):
            texts = stream[:q]
            if q > 1:
                texts[1] = " "                       # a featureless row
            q_pad = ops.pad_pow2(q)
            ids, w = ctx.padded_feature_tensors(
                texts, want_full=True, want_instr=mode == "both",
                q_pad=q_pad)
            ids_d = torch.from_numpy(ids).to(dev)
            w_d = torch.from_numpy(w).to(dev)
            out = ops.hashed_embed(ids_d, w_d, proj)
            ref = hashed_embed_ref(ids_d, w_d, proj)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if not err <= FEATURIZE_TOL:
                raise AssertionError(f"featurize {mode} Q={q}: max abs err "
                                     f"{err} > {FEATURIZE_TOL}")
            worst = max(worst, err)
            ms = cuda_ms(lambda: kernel.hashed_embed_fwd(ids_d, w_d, proj))
            plain_ms = cuda_ms(lambda: hashed_embed_ref(ids_d, w_d, proj))
            # what this data needs.  bytes: ids and weights read once, the
            # output written once, and of the projection only the rows of
            # buckets that some row of the batch hits (the kernel reads no
            # other); operations: a multiply-add per (row, non-zero
            # bucket, column), the scatter, log1p, the norm
            nnz = int((torch.zeros(ids.shape[0], proj.shape[0], device=dev)
                       .scatter_add_(1, ids_d.long().clamp(min=0),
                                     (ids_d >= 0).float()) > 0).sum())
            hit = int(torch.unique(ids_d[ids_d >= 0]).numel())
            n_bytes = (ids.size + w.size + hit * proj.shape[1]
                       + ids.shape[0] * proj.shape[1]) * 4
            n_ops = (2 * nnz * proj.shape[1] + ids.size
                     + ids.shape[0] * (proj.shape[0] + 3 * proj.shape[1]))
            b_ms, b_by = bound(n_bytes, n_ops)
            rows.append(dict(mode=mode, q=q, rows=ids.shape[0],
                             l=ids.shape[1], err=err, ms=ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
            log("kernels", f"featurize mode={mode} Q={q} ({ids.shape[0]}x"
                f"{ids.shape[1]} ids, {hit} buckets hit, {nnz} row-bucket "
                f"pairs): err {err:.3g}, kernel {ms:.6f} ms, plain "
                f"{plain_ms:.6f} ms, bound {b_ms:.6f} ms ({b_by})")
    return {"rows": rows, "worst": worst}


def linucb_phase(dev) -> dict:
    from repro_torch.kernels.linucb import kernel, ops
    from repro_torch.kernels.linucb.ref import linucb_scores_ref

    rng = np.random.default_rng(5)
    rows, worst = [], 0.0
    for m, d, q in ((64, 12, 1), (64, 12, 16), (64, 12, 64), (64, 128, 1024)):
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
        a_d, t_d, x_d = (torch.from_numpy(np.ascontiguousarray(v, np.float32))
                         .to(dev) for v in (a_inv, theta, x))
        out = ops.linucb_scores(a_d, t_d, x_d, 0.1)
        ref = linucb_scores_ref(a_d, t_d, x_d, 0.1)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not err <= LINUCB_TOL:
            raise AssertionError(f"linucb M={m} d={d} Q={q}: max abs err "
                                 f"{err} > {LINUCB_TOL}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: kernel.linucb_scores_fwd(a_d, t_d, x_d, 0.1))
        plain_ms = cuda_ms(lambda: linucb_scores_ref(a_d, t_d, x_d, 0.1))
        n_bytes = (m * d * d + m * d + q * d + q * m) * 4
        n_ops = q * m * (2 * d * d + 2 * d + 4)
        b_ms, b_by = bound(n_bytes, n_ops)
        rows.append(dict(m=m, d=d, q=q, err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by))
        log("kernels", f"linucb M={m} d={d} Q={q}: err {err:.3g}, kernel "
            f"{ms:.6f} ms, plain {plain_ms:.6f} ms, bound {b_ms:.6f} ms "
            f"({b_by})")
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
        pool = ModelPool([ModelProfile(name=a, family="dense", params_b=p)
                          for a, p in zip(SERVE_ARCHS, (8.2, 4.0))])
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
            f"{np.bincount([x[0] for x in rows], minlength=2)}")
    if seen["device"] != seen["host"]:
        bad = [i for i, (a, b) in enumerate(zip(seen["device"], seen["host"]))
               if a != b]
        raise AssertionError(f"device and host routing differ at {bad[:8]}")
    log("router", f"64 queries: arms, labels, clusters, bins identical on "
        f"both featurize paths (classifier train acc {acc:.3f})")


# ---------------------------------------------------------------------------
# 5. serving through PoolServer on two full-width engines
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
    from repro_torch.kernels.featurize import ops as featurize_ops
    from repro_torch.kernels.linucb import ops as linucb_ops
    from repro_torch.serving.engine import ModelEngine
    from repro_torch.serving.scheduler import PoolServer

    t0 = time.perf_counter()
    engines = {}
    for i, arch in enumerate(SERVE_ARCHS):
        cfg = for_mode(get_config(arch, vocab_size=tok.VOCAB_SIZE,
                                  max_seq_len=192), "serve")
        engines[arch] = ModelEngine(arch, cfg, seed=i, max_batch=4,
                                    max_len=192, detokenize=tok.decode,
                                    prefill_chunk=8, device=dev)
        log("serve", f"{arch}: {cfg.n_layers}/{cfg.n_layers} layers (no "
            f"depth cut), d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
            f"{cfg.param_count() / 1e9:.2f} B params in bf16")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    router = GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05),
                             ModelPool([e.profile for e in engines.values()]),
                             device=dev)
    server = PoolServer(router, engines, tokenizer=tok.encode,
                        accuracy_fn=exact_match_accuracy, prefill_chunk=8)
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
    featurize_ops.launches = 0
    linucb_ops.launches = 0
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
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t1
    launches = {"featurize": featurize_ops.launches,
                "linucb": linucb_ops.launches}
    if len(server.responses) != len(arrivals):
        raise AssertionError(f"{len(server.responses)}/{len(arrivals)} "
                             f"queries answered")
    for name, eng in engines.items():
        if eng.nonfinite_ticks:
            raise AssertionError(f"{name}: {eng.nonfinite_ticks} ticks with "
                                 f"non-finite logits")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {name}")
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
        f"their first token")
    for name, e in engines.items():
        n_c, n_d = e.tick_counts["chunk"], e.tick_counts["decode"]
        s_c, s_d = e.tick_seconds["chunk"], e.tick_seconds["decode"]
        prompt = sum(r.input_tokens for r in resp if r.model_name == name)
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
        f"{per_q['complexity']:.4f} ms/query; launches {launches}")
    log("serve", f"max_memory_allocated {torch.cuda.max_memory_allocated(dev)}"
        f" bytes; modeled energy "
        f"{sum(r.energy_wh for r in resp):.6f} Wh")
    for key, what in (("busy", "kernels over the window's own wall time"),
                      ("busy_before", "kernels over the unprofiled steps "
                       "just before")):
        busy = [w[key] for w in windows]
        each = ", ".join(f"{w['label']} {w[key]:.4f}" for w in windows)
        log("profile", f"card busy share, {what}: {each} (min "
            f"{min(busy):.4f}, max {max(busy):.4f})")
    return launches


def profile_window(server, pending, label: str, before_s) -> dict:
    """Where a serving step's time goes, in one window of the main run:
    ``PROFILE_STEPS`` scheduler steps (still enqueueing one arrival each)
    under torch.profiler with device activity.  The card's busy share
    is the kernels' summed device time over the same steps' wall time; the
    profiler lengthens the host side, so the unprofiled steps just before
    (``before_s``) are printed beside it for scale."""
    from torch.autograd import DeviceType
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / PROFILE_STEPS
    if dev_ms <= 0:
        raise AssertionError(f"{label} window: the profiler recorded no "
                             f"kernel time on the card")
    before_ms = sum(before_s) / len(before_s) * 1e3
    ticks = {n: {k: v - ticks0[n][k] for k, v in e.tick_counts.items()}
             for n, e in server.engines.items()}
    log("profile", f"{label} window (steps {server._step_idx - PROFILE_STEPS + 1}"
        f"-{server._step_idx}): {dev_ms:.3f} ms of kernels per step over "
        f"{wall_ms:.3f} ms wall per step → card busy {dev_ms / wall_ms:.4f}; "
        f"the {len(before_s)} unprofiled steps before took {before_ms:.3f} "
        f"ms each ({dev_ms / before_ms:.4f}); engine ticks in the window "
        f"{ticks}")
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    for e in top:
        log("profile", f"  {e.self_device_time_total / 1e3 / PROFILE_STEPS:8.3f}"
            f" ms/step  {e.count / PROFILE_STEPS:7.1f} calls/step  "
            f"{e.key[:70]}")
    return {"label": label, "dev_ms": dev_ms, "wall_ms": wall_ms,
            "busy": dev_ms / wall_ms, "busy_before": dev_ms / before_ms}


# ---------------------------------------------------------------------------
# 6. bf16 vs fp32 on two full-width granite layers
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
    m32 = lm.DenseLM(cfg32, dev)
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

    t = time.perf_counter()
    feat = featurize_phase(dev)
    lin = linucb_phase(dev)
    log("kernels", f"phase {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    router_phase(dev)
    log("router", f"phase {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    launches = serving_phase(dev)
    log("serve", f"phase {time.perf_counter() - t:.2f} s")
    t = time.perf_counter()
    engine_crosscheck(dev)
    log("crosscheck", f"phase {time.perf_counter() - t:.2f} s")

    # the main path (serving, enqueue one per step) routes admission
    # batches of one: the kernel rows below are at Q = 1
    f1 = next(r for r in feat["rows"] if r["mode"] == "both" and r["q"] == 1)
    l1 = next(r for r in lin["rows"] if r["d"] == 12 and r["q"] == 1)
    kernels = [
        {"name": "featurize", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/featurize.cu",
         "replaces": "src/repro/kernels/featurize/kernel.py:37",
         "launches": launches["featurize"], "max_abs_err": feat["worst"],
         "ms": f1["ms"], "plain_ms": f1["plain_ms"],
         "bound_ms": f1["bound_ms"], "bound_by": f1["bound_by"],
         "library_ms": None},
        {"name": "linucb", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/linucb.cu",
         "replaces": "src/repro/kernels/linucb/kernel.py:25",
         "launches": launches["linucb"], "max_abs_err": lin["worst"],
         "ms": l1["ms"], "plain_ms": l1["plain_ms"],
         "bound_ms": l1["bound_ms"], "bound_by": l1["bound_by"],
         "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
