"""End-to-end serving driver: real (reduced-config) models behind the
GreenServ router with continuous batching, hedging, and a mid-run model
addition — the paper's online deployment (§4.4) in one script.  The
PyTorch package's twin of ``examples/serve_pool.py``: the same flags and
lines, plus ``--device`` (the engines' and router's device; default: the
card).  On the card the smoke configs set ``use_pallas``, the port's
kernel switch: qwen2-moe's top-k gate runs through the hand-written
gating kernel.

    PYTHONPATH=src python examples/torch_serve_pool.py [--queries 40] \
        [--device cpu]

``main(argv, weights)`` takes ``weights``, a map from an arch to a built
model, a ``(model, cfg)`` pair that arch's engine serves at ``cfg`` (the
JAX package's weights carried by ``models/convert.py``, or full-width
models on the card); the others get smoke configs with weights drawn from
their seeds (the pool's 0 and 1, the added model's 42).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import RouterConfig
from repro_torch.data import stream as stream_lib
from repro_torch.data import tokenizer as tok
from repro_torch.device import resolve_device
from repro_torch.launch.serve import exact_match_accuracy
from repro_torch.serving import ModelEngine, PoolServer

POOL = ["rwkv6-1.6b", "qwen2-moe-a2.7b"]
ADDED, ADDED_SEED = "granite-3-8b", 42
MAX_LEN = 192


def engine(arch, seed, weights, device, prefill_chunk=1, **cfg_kw):
    """``arch``'s engine: the model ``weights`` holds for it, or a smoke
    config (``cfg_kw`` over it) with weights drawn from ``seed``."""
    if arch in weights:
        model, cfg = weights[arch]
    else:
        on_card = resolve_device(device).type == "cuda"
        model, cfg = None, get_config(arch, smoke=True,
                                      vocab_size=tok.VOCAB_SIZE,
                                      use_pallas=on_card, **cfg_kw)
    return ModelEngine(arch, cfg, seed, max_batch=4, max_len=MAX_LEN,
                       params=model, detokenize=tok.decode,
                       prefill_chunk=prefill_chunk, device=device)


def main(argv=None, weights=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--queries", type=int, default=30)
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens per engine prefill tick (1 = legacy "
                         "token-wise; rwkv falls back to 1, qwen-moe chunks)")
    ap.add_argument("--device", default=None,
                    help="the engines' and router's device (default: the "
                         "card)")
    args = ap.parse_args(argv)
    weights = weights or {}

    engines = {arch: engine(arch, i, weights, args.device,
                            prefill_chunk=args.prefill_chunk,
                            max_seq_len=MAX_LEN)
               for i, arch in enumerate(POOL)}
    pool = ModelPool([e.profile for e in engines.values()])
    router = GreenServRouter(RouterConfig(lam=0.4, energy_scale_wh=0.05,
                                          max_arms=16), pool,
                             device=args.device)
    server = PoolServer(router, engines, tokenizer=tok.encode,
                        hedge_after_steps=30,
                        accuracy_fn=exact_match_accuracy,
                        prefill_chunk=args.prefill_chunk)

    queries = stream_lib.make_stream(per_task=max(args.queries // 5, 1))
    queries = queries[: args.queries]
    t0 = time.monotonic()
    for i, q in enumerate(queries):
        server.submit(q)
        server.step()
        if i == len(queries) // 2:
            # zero-calibration model addition mid-stream (paper §6.3.4)
            eng = engine(ADDED, ADDED_SEED, weights, args.device)
            server.add_engine(eng.profile, eng)
            print(f"[t={i}] added {ADDED} to the pool "
                  f"(router arms: {router.policy.n_arms})")
    server.run_until_drained()

    print(f"\n{len(server.responses)}/{len(queries)} queries in "
          f"{time.monotonic() - t0:.1f}s  "
          f"(hedges={server.stats['hedges']}, "
          f"restarts={server.stats['restarts']})")
    for name, n in zip(pool.names, router.selection_counts()):
        print(f"  {name:18s} routed {int(n):3d}×")
    wh = sum(r.energy_wh for r in server.responses.values())
    print(f"modeled energy: {wh * 1e3:.3f} mWh; routing overhead "
          f"{router.mean_decision_ms:.2f} ms/query")
    return {"server": server, "queries": queries}


if __name__ == "__main__":
    main()
