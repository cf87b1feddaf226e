"""Quickstart: route a query stream through GreenServ in 40 lines — the
PyTorch package's twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The router runs on the card (featurize "auto": the device path) unless
``--device`` names another device; the lines it prints are the JAX
example's.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.pool import build_paper_pool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, RouterConfig
from repro_torch.data import ENERGY_SCALE_WH, OutcomeSimulator
from repro_torch.data.stream import labeled_sample, make_stream


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="the router's device (default: the card)")
    args = ap.parse_args(argv)

    # 1. the 16-model pool of the paper (profiles only; outcomes simulated)
    pool = build_paper_pool()

    # 2. the router: LinUCB over [task, cluster, complexity] context features
    router = GreenServRouter(
        RouterConfig(lam=0.4, energy_scale_wh=ENERGY_SCALE_WH, max_arms=32),
        pool, device=args.device)
    texts, labels = labeled_sample(n_per_task=40)
    router.context.task_classifier.fit(texts, labels, steps=150)

    # 3. stream queries; observe partial feedback; the policy learns online
    sim = OutcomeSimulator(seed=7)
    total_acc = total_wh = 0.0
    for q in make_stream(per_task=100):          # T = 500
        decision = router.route(q)
        acc, energy_wh, latency_ms, _ = sim(q, decision.model_name)
        router.feedback(Feedback(query_uid=q.uid,
                                 model_index=decision.model_index,
                                 accuracy=acc, energy_wh=energy_wh,
                                 latency_ms=latency_ms))
        total_acc += acc
        total_wh += energy_wh

    print(f"mean accuracy     : {total_acc / 500:.3f}")
    print(f"total energy      : {total_wh:.1f} Wh")
    print(f"routing overhead  : {router.mean_decision_ms:.2f} ms/query")
    print("selection counts  :")
    counts = {}
    for name, n in zip(pool.names, router.selection_counts()):
        if n:
            print(f"  {name:16s} {int(n):4d}")
            counts[name] = int(n)
    return {"accuracy": total_acc / 500, "energy_wh": total_wh,
            "selections": counts, "decision_ms": router.mean_decision_ms}


if __name__ == "__main__":
    main()
