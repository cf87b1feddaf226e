"""The paper's remaining experiments in the port on the CPU against the JAX
package's reference benches (``benchmarks/bench_*.py``), at ``per_task``
30 (T = 150, where the policies' trajectories are exact across the two
packages: ``test_torch_paper_loop.py``):

  * ``lambda_sweep`` (Fig. 4): every λ row, accuracy and Wh within 1e-9,
    one seed (``n_runs`` 1) to keep the file's time;
  * ``features`` (Fig. 5): every feature set's regrets within 1e-9; the
    ``--perf`` mode's rows (batch × path, the backend named) and host ==
    device parity on the device path's plain versions;
  * ``model_addition`` (Fig. 6): the selection trace, before and after;
  * ``overhead`` (Tables 3–4): the table's rows and components, not the
    timings;
  * ``prefill``: steps to the first token and per-phase joules at each
    chunk (the port's energy constants set to the JAX package's);
  * ``energy_model``: the ``BENCH_energy.json`` artifact (every cell's
    MAE, migrations, joules and trajectory, the sim pool's counts) within
    1e-9, the cells' engines on the JAX weights, with ``--smoke``'s gates.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from benchmarks import (bench_energy_model, bench_features,
                        bench_lambda_sweep, bench_model_addition,
                        bench_overhead, bench_prefill)
from repro.models import api as jax_api
from repro_torch.benchmarks import (energy_model, features, lambda_sweep,
                                    model_addition, overhead, prefill)
from repro_torch.models.convert import params_from_jax
from test_torch_costmodel import assert_close, one_torch_thread  # noqa: F401
from test_torch_serving import equal_energy_constants  # noqa: F401

pytestmark = pytest.mark.port

PER_TASK = 30
RUNS = 1
EXACT = 1e-9
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def lambda_rows():
    """(the port's rows, the JAX package's) of the λ sweep."""
    return (lambda_sweep.run(per_task=PER_TASK, n_runs=RUNS, **CPU),
            bench_lambda_sweep.run(per_task=PER_TASK, n_runs=RUNS))


@pytest.fixture(scope="module")
def ablation():
    """(the port's regrets, the JAX package's) of the feature ablation."""
    return (features.run(per_task=PER_TASK, n_runs=RUNS, **CPU),
            bench_features.run(per_task=PER_TASK, n_runs=RUNS))


def test_lambda_sweep_matches_jax(lambda_rows):
    got, want = lambda_rows
    assert [r[0] for r in got] == [r[0] for r in want] == list(
        lambda_sweep.LAMBDAS)
    assert_close([list(r) for r in got], [list(r) for r in want], EXACT)


def test_lambda_sweep_table_matches_jax(lambda_rows, monkeypatch):
    """``main``'s lines from each package's rows."""
    got, want = lambda_rows
    monkeypatch.setattr(lambda_sweep, "run", lambda **kw: got)
    monkeypatch.setattr(bench_lambda_sweep, "run", lambda **kw: want)
    assert lambda_sweep.main(per_task=PER_TASK, **CPU) == \
        bench_lambda_sweep.main(per_task=PER_TASK)


def test_feature_ablation_matches_jax(ablation):
    got, want = ablation
    assert list(got) == list(want) == list(features.CONFIGS)
    assert_close(got, want, EXACT)


def test_feature_ablation_table_matches_jax(ablation, monkeypatch):
    got, want = ablation
    monkeypatch.setattr(features, "run", lambda **kw: got)
    monkeypatch.setattr(bench_features, "run", lambda **kw: want)
    assert features.main(**CPU) == bench_features.main()


def test_features_perf_rows_and_parity():
    """The perf mode's rows, batch × path as the reference's, each naming
    the device it ran on; ``--smoke``'s parity on the device path's plain
    versions (embeddings 1e-5, identical decisions)."""
    lines = features.perf_main(batch_sizes=(1, 16, 64), n_iter=1,
                               smoke=True, **CPU)
    rows = [tuple(l.split(",")[:2]) for l in lines[1:7]]
    assert lines[0] == "batch,path,featurize_texts_per_s,decision_ms"
    assert rows == [(str(b), p) for b in (1, 16, 64)
                    for p in ("host", "device")]
    assert lines[7].endswith("(cpu)")
    assert "# parity: host vs device embeddings + decisions OK" in lines
    assert {r["backend"] for r in features.perf(batch_sizes=(1,), n_iter=1,
                                                **CPU)} == {"cpu"}


def test_model_addition_matches_jax():
    """Fig. 6 at T = 150 with the addition at query 30 (``main``'s rule,
    ``min(1000, 5·per_task − 500)``, needs per_task ≥ 101)."""
    jres, jbefore, jafter = bench_model_addition.run(per_task=PER_TASK,
                                                     add_at=30)
    res, before, after = model_addition.run(per_task=PER_TASK, add_at=30,
                                            **CPU)
    np.testing.assert_array_equal(res.selection_trace, jres.selection_trace)
    assert (before, after) == (jbefore, jafter)
    assert before == 0.0
    assert_close([res.mean_accuracy, res.total_energy_wh,
                  res.cumulative_regret],
                  [jres.mean_accuracy, jres.total_energy_wh,
                   jres.cumulative_regret], EXACT)


def test_overhead_table_matches_jax():
    """Tables 3–4: the same rows in the same order, every component and
    every paper-pool model present; the ms are this host's and not
    compared."""
    want = bench_overhead.main(n_queries=40)
    got = overhead.main(n_queries=40, **CPU)
    assert [l.split(",")[0] for l in got] == [l.split(",")[0] for l in want]
    feature_ms, decision_ms = overhead.run(n_queries=10, **CPU)
    assert set(feature_ms) == {"task", "cluster", "complexity", "featurize"}
    assert list(decision_ms) == ["linucb", "eps_greedy", "cts"]
    assert all(v >= 0 for v in list(feature_ms.values())
               + list(decision_ms.values()))


def test_prefill_steps_and_joules_match_jax(equal_energy_constants):
    """Steps to the first token and each phase's joules at every chunk;
    the wall seconds are this host's and not compared (nor the header's
    wording)."""
    kw = dict(prompt_len=24, chunks=(1, 4, 8))
    want = bench_prefill.main("granite-3-8b", **kw)
    got = prefill.main("granite-3-8b", **kw, **CPU)

    def drop_wall(lines):
        return [l if "," not in l or l.startswith("chunk")
                else ",".join(f for i, f in enumerate(l.split(",")) if i != 3)
                for l in lines]

    assert drop_wall(got[1:]) == drop_wall(want[1:])
    assert [l.split(",")[1] for l in got[2:]] == ["24", "6", "3"]


def test_energy_model_artifact_matches_jax(tmp_path, equal_energy_constants):
    """Both benches at 24 queries a cell with ``--smoke``'s gates; the
    port's cells serve the JAX package's weights (each cell's
    ``PRNGKey(seed)`` draw, carried by ``params_from_jax``)."""
    n, seed = 24, 0
    weights = {}
    for arch in energy_model.ARCHS:
        cfg = energy_model.cell_config(arch)
        jcfg = bench_energy_model.get_config(
            arch, smoke=True, vocab_size=cfg.vocab_size, dtype="float32",
            max_seq_len=energy_model.MAX_LEN)
        params = jax_api.init_params(jcfg, jax.random.PRNGKey(seed))
        weights[arch] = params_from_jax(jax.tree.map(np.asarray, params),
                                        cfg, device="cpu")
    paths = {k: tmp_path / f"{k}.json" for k in ("jax", "port")}
    want_lines = bench_energy_model.main(n_queries=n, smoke=True,
                                         artifact=str(paths["jax"]),
                                         seed=seed)
    got_lines = energy_model.main(n_queries=n, smoke=True,
                                  artifact=str(paths["port"]), seed=seed,
                                  weights=weights, **CPU)
    assert got_lines[:-1] == want_lines[:-1]
    got, want = (json.loads(paths[k].read_text()) for k in ("port", "jax"))
    assert_close(got, want, EXACT)
    assert len(want["headline"]["mae_by_cell"]) == 6
