"""Paper Fig. 5: the contextual-feature ablation (task / cluster /
complexity), and ``--perf``: featurization throughput and ``route_batch``
decision latency, the host path against the device path (the featurize
and LinUCB kernels), at serving batch sizes.

    PYTHONPATH=src python -m repro_torch.benchmarks.features          # ablation
    PYTHONPATH=src python -m repro_torch.benchmarks.features --perf   # perf mode
    PYTHONPATH=src python -m repro_torch.benchmarks.features --smoke --out f.jsonl

``--smoke`` runs the perf mode and asserts host/device parity (embeddings
within 1e-5, identical routing decisions); it prints the device/host
throughput ratio and asserts no ratio.  Every router runs on ``--device``
(default: the card; ``--device cpu`` runs the device path's plain
versions on the CPU), and each row's ``backend`` names that device.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import make_router, run_policy, stream
from repro_torch.core.embedding import EmbeddingModel
from repro_torch.core.types import Feedback, Query
from repro_torch.data import OutcomeSimulator
from repro_torch.device import resolve_device

CONFIGS = {
    "none": (False, False, False),
    "task": (True, False, False),
    "cluster": (False, True, False),
    "complexity": (False, False, True),
    "task+cluster": (True, True, False),
    "task+complexity": (True, False, True),
    "cluster+complexity": (False, True, True),
    "full": (True, True, True),
}
PARITY_TOL = 1e-5


def run(per_task: int = 200, n_runs: int = 3,
        device=None) -> Dict[str, List[float]]:
    """Cumulative regret of each feature set over ``n_runs`` seeds."""
    qs = stream(per_task=per_task)
    out: Dict[str, List[float]] = {}
    for name, feats in CONFIGS.items():
        regrets = []
        for i in range(n_runs):
            router = make_router(lam=0.4, features=feats, seed=i,
                                 device=device)
            sim = OutcomeSimulator(seed=i + 50)
            regrets.append(run_policy(router, qs, sim, name)
                           .cumulative_regret)
        out[name] = regrets
    return out


def main(per_task: int = 200, n_runs: int = 2, device=None) -> List[str]:
    res = run(per_task=per_task, n_runs=n_runs, device=device)
    lines = ["features,median_cumulative_regret"]
    for name, regs in res.items():
        lines.append(f"{name},{np.median(regs):.1f}")
    task_med = np.median(res["task"])
    none_med = np.median(res["none"])
    lines.append(f"# paper: task feature is the most informative — "
                 f"task<{'=' if task_med <= none_med else '!'}none "
                 f"({task_med:.0f} vs {none_med:.0f})")
    return lines


# ---------------------------------------------------------------------------
# Featurization throughput + decision latency: host vs device.
# ---------------------------------------------------------------------------


def backend(device) -> str:
    """The name of the device the routers run on."""
    dev = resolve_device(device)
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)


def _warm_router(router, n: int = 8) -> None:
    """Identical feedback history → identical bandit/k-means state, so the
    host and device routers decide from the same posterior."""
    for i in range(n):
        q = Query(uid=900_000 + i,
                  text=f"Summarize the following.\nDoc {i} on topic {i % 3} "
                       f"with extra detail words")
        d = router.route(q)
        router.feedback(Feedback(
            query_uid=q.uid, model_index=d.model_index,
            accuracy=0.3 + 0.2 * (d.model_index % 3),
            energy_wh=0.01 * (d.model_index + 1), latency_ms=5.0))


def _time_encode(fn, texts, n_iter: int) -> float:
    """Median wall seconds per call after one warm-up call (each call ends
    in a device → host copy)."""
    fn(texts)
    times = []
    for _ in range(n_iter):
        t0 = time.perf_counter()
        fn(texts)
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def perf(batch_sizes=(1, 16, 64), n_iter: int = 5, seed: int = 0,
         device=None) -> List[dict]:
    """Per (batch, path) rows: featurization throughput (texts/s) and the
    median ``route_batch`` decision latency (ms), host path vs device
    path."""
    dev = resolve_device(device)
    texts = [q.text for q in stream(per_task=13)][: max(batch_sizes)]
    rows: List[dict] = []
    for batch in batch_sizes:
        chunk = texts[:batch]
        for path in ("host", "device"):
            em = EmbeddingModel()
            enc = (em.encode_batch if path == "host"
                   else lambda t: em.encode_batch_device(t, dev))
            sec = _time_encode(enc, chunk, n_iter)
            router = make_router(lam=0.4, seed=seed, device=dev,
                                 featurize=path)
            _warm_router(router)
            qs0 = [Query(uid=1_000_000 + i, text=t)
                   for i, t in enumerate(chunk)]
            router.route_batch(qs0)          # warm-up
            dec_ms = []
            for it in range(n_iter):
                qs = [Query(uid=2_000_000 + it * batch + i, text=t)
                      for i, t in enumerate(chunk)]
                t0 = time.perf_counter()
                router.route_batch(qs)
                dec_ms.append((time.perf_counter() - t0) * 1e3)
            rows.append({
                "batch": batch,
                "path": path,
                "featurize_qps": batch / max(sec, 1e-9),
                "decision_ms": float(np.median(dec_ms)),
                "backend": backend(dev),
            })
    return rows


def assert_parity(seed: int = 0, device=None) -> None:
    """Host and device featurization agree: embeddings within
    ``PARITY_TOL``, routing decisions identical."""
    dev = resolve_device(device)
    texts = [q.text for q in stream(per_task=8)][:40]
    em = EmbeddingModel()
    np.testing.assert_allclose(em.encode_batch_device(texts, dev),
                               em.encode_batch(texts), atol=PARITY_TOL)
    routers = [make_router(lam=0.4, seed=seed, device=dev, featurize=path)
               for path in ("host", "device")]
    qs = [Query(uid=3_000_000 + i, text=t) for i, t in enumerate(texts)]
    decisions = []
    for r in routers:
        _warm_router(r)
        decisions.append([d.model_index for d in r.route_batch(qs)])
    assert decisions[0] == decisions[1], "host/device decision skew"


def perf_main(batch_sizes=(1, 16, 64), n_iter: int = 5, smoke: bool = False,
              out: Optional[str] = None, seed: int = 0,
              device=None) -> List[str]:
    rows = perf(batch_sizes=batch_sizes, n_iter=n_iter, seed=seed,
                device=device)
    lines = ["batch,path,featurize_texts_per_s,decision_ms"]
    for r in rows:
        lines.append(f"{r['batch']},{r['path']},{r['featurize_qps']:.0f},"
                     f"{r['decision_ms']:.3f}")
    by_key = {(r["batch"], r["path"]): r for r in rows}
    top = max(batch_sizes)
    ratio = (by_key[(top, "device")]["featurize_qps"]
             / max(by_key[(top, "host")]["featurize_qps"], 1e-9))
    lines.append(f"# device/host featurization throughput at batch {top}: "
                 f"{ratio:.2f}x ({rows[0]['backend']})")
    if smoke:
        assert_parity(seed=seed, device=device)
        lines.append("# parity: host vs device embeddings + decisions OK")
    if out:
        with open(out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
        lines.append(f"dump,rows,{len(rows)}")
        lines.append(f"dump,path,{out}")
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--perf", action="store_true",
                    help="featurization-throughput + decision-latency mode "
                         "(host vs device) instead of the Fig. 5 ablation")
    ap.add_argument("--smoke", action="store_true",
                    help="perf mode + host/device parity asserts")
    ap.add_argument("--out", default=None,
                    help="JSONL metrics dump path (perf mode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the routers' device (default: the card)")
    args = ap.parse_args()
    if args.perf or args.smoke:
        print("\n".join(perf_main(smoke=args.smoke, out=args.out,
                                  seed=args.seed, device=args.device)))
    else:
        print("\n".join(main(device=args.device)))
