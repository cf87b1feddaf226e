"""The paper's own claims (``tests/test_paper_claims.py``) on the port's
harness: the same seven assertions, at the same reduced T = 750, on the
port's routers (on the CPU here; ``chip_smoke.py`` asserts them at T =
2,500 on the card)."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.benchmarks.common import make_router, run_policy, stream
from repro_torch.core.types import TaskType
from repro_torch.data import OutcomeSimulator
from repro_torch.data.profiles import ACCURACY, mean_energy_mwh
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port


@pytest.fixture(scope="module")
def results():
    qs = stream(per_task=150)          # T = 750 (paper: 2,500)
    out = {}
    router = make_router(lam=0.4, seed=0, device="cpu")
    out["greenserv"] = run_policy(router, qs, OutcomeSimulator(7),
                                  "greenserv")
    out["random"] = run_policy(None, qs, OutcomeSimulator(7), "random",
                               random_seed=3)
    out["largest"] = run_policy(None, qs, OutcomeSimulator(7), "largest",
                                static_model="yi-34b")
    out["smallest"] = run_policy(None, qs, OutcomeSimulator(7), "smallest",
                                 static_model="qwen2.5-0.5b")
    out["best"] = run_policy(None, qs, OutcomeSimulator(7), "best",
                             static_model="gemma-3-27b")
    nonctx = make_router(lam=0.4, algorithm="eps_greedy",
                         features=(False, False, False), seed=0,
                         device="cpu")
    out["nonctx"] = run_policy(nonctx, qs, OutcomeSimulator(7), "nonctx")
    return out


def test_greenserv_beats_random_accuracy(results):
    """Paper: +22% accuracy vs random routing."""
    gain = results["greenserv"].mean_accuracy / results["random"].mean_accuracy
    assert gain > 1.10, gain


def test_greenserv_saves_energy_vs_random(results):
    """Paper: −31% cumulative energy vs random routing."""
    ratio = (results["greenserv"].total_energy_wh
             / results["random"].total_energy_wh)
    assert ratio < 0.95, ratio


def test_static_baseline_ordering(results):
    """Paper Fig. 2a orderings: best-static most accurate AND most energy;
    smallest least energy; largest mediocre accuracy."""
    assert results["best"].mean_accuracy > results["greenserv"].mean_accuracy
    assert (results["best"].total_energy_wh
            > 3 * results["greenserv"].total_energy_wh)
    assert (results["smallest"].total_energy_wh
            < results["greenserv"].total_energy_wh)
    assert results["largest"].mean_accuracy < 0.45


def test_contextual_regret_below_noncontextual(results):
    """Paper Fig. 3, with the reference test's slack at T = 750."""
    assert (results["greenserv"].cumulative_regret
            < 1.25 * results["nonctx"].cumulative_regret)


def test_regret_sublinear(results):
    """Learning: per-step regret in the last quarter ≪ the first quarter."""
    curve = results["greenserv"].regret_curve
    t = len(curve)
    first = curve[t // 4] / (t // 4)
    last = (curve[-1] - curve[3 * t // 4]) / (t - 3 * t // 4)
    assert last < 0.6 * first, (first, last)


def test_greenserv_near_static_pareto(results):
    """Paper: GreenServ reaches accuracy-energy points no single model
    offers — more accurate than anything at comparable energy."""
    gs = results["greenserv"]
    for m, accs in ACCURACY.items():
        e = np.mean([mean_energy_mwh(m, t) / 1e3 for t in TaskType])
        acc = np.mean(accs)
        per_q = gs.total_energy_wh / len(gs.selection_trace)
        if e <= per_q * 1.05:
            assert acc <= gs.mean_accuracy + 0.02, \
                (m, acc, gs.mean_accuracy)


def test_routing_overhead_small(results):
    """Paper Table 4: ≈7 ms/query total; assert same order of magnitude."""
    assert results["greenserv"].mean_decision_ms < 25.0
