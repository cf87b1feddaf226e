"""The example twins (``examples/torch_*.py``) on the CPU against the JAX
package's examples:

  * ``torch_quickstart``, ``torch_lambda_tradeoff`` and
    ``torch_energy_budget`` (``SimEngine`` pools) print the reference
    scripts' lines, every number exact; only what reads the wall clock is
    left out of the comparison (the routing overhead in ms, the queue
    wait, the power trace's average and peak watts; its total Wh is
    compared).  ``energy_budget.py`` takes a size (``--per-task``), so it
    runs here beside its twin: at 120 a task, where the governor holds
    its cap, and with ``--carbon`` at 40, where it cannot.
    The other two have no size flag and cost more than 40 s of serial
    time at their fixed sizes, so their output is recorded here, with the
    command that produced it (``JAX_PLATFORMS=cpu PYTHONPATH=src``, from
    the repo root, jax 0.9.0);
  * ``torch_serve_pool`` at ``--queries 8`` on the JAX example's own
    engine weights (its 2-layer smoke configs, run in fp32 on both sides,
    carried by ``models/convert.py``; the port's energy constants set to
    the JAX package's): every query answered, each on the same model with
    the same tokens, the same hedges and restarts, the same routed counts
    and the mid-run addition of granite-3-8b.
"""
import functools
import importlib.util
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import repro.configs
import repro.launch.serve
import repro.serving
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from test_torch_costmodel import one_torch_thread  # noqa: F401
from test_torch_serving import equal_energy_constants  # noqa: F401

pytestmark = pytest.mark.port

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
F32 = dict(dtype="float32", param_dtype="float32")

# python examples/quickstart.py
QUICKSTART = """\
mean accuracy     : 0.605
total energy      : 31.9 Wh
routing overhead  : 5.37 ms/query
selection counts  :
  qwen2.5-0.5b        9
  qwen2.5-1.5b       21
  qwen2.5-3b         50
  qwen2.5-7b         11
  qwen2.5-14b        50
  mistral-7b         20
  gemma-3-1b         14
  gemma-3-4b         17
  gemma-3-12b        84
  gemma-3-27b        36
  llama-3.1-1b       13
  llama-3.2-3b       80
  llama-3.1-8b       56
  phi-4-mini-4b      22
  phi-4-14b          12
  yi-34b              5
"""

# python examples/lambda_tradeoff.py
LAMBDA_TRADEOFF = """\
   λ  accuracy  energy(Wh)  policy mix (top-3)
 0.0     0.641       119.7  gemma-3-27b×268, phi-4-14b×54, qwen2.5-3b×25
 0.2     0.604        41.6  phi-4-14b×134, gemma-3-27b×92, llama-3.2-3b×73
 0.4     0.542        32.9  qwen2.5-14b×79, gemma-3-12b×52, yi-34b×49
 0.6     0.516        22.9  phi-4-mini-4b×49, phi-4-14b×45, mistral-7b×44
 0.8     0.486        17.3  qwen2.5-0.5b×92, qwen2.5-7b×43, llama-3.1-8b×43
 1.0     0.392        13.7  qwen2.5-0.5b×172, llama-3.1-1b×57, qwen2.5-1.5b×42

λ=0 chases accuracy (big models); λ=1 chases joules (small ones);
the bandit walks the Pareto front in between — no recalibration.
"""

def _example(name: str):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _deterministic(text: str) -> list:
    """The lines that do not read the wall clock: no routing overhead, no
    queue wait, and of the power trace only its total Wh."""
    out = []
    for line in text.rstrip().splitlines():
        head = line.strip()
        if "routing overhead" in line or head.startswith("queue"):
            continue
        if head.startswith("power"):
            line = "power total " + line.split("total")[-1].strip()
        out.append(line.rstrip())
    return out


def _reference_output(name: str, argv: list, monkeypatch, capsys) -> str:
    """What ``examples/<name>.py`` prints with ``argv``, run as a script
    from the repo root (it reaches ``benchmarks.common`` from there)."""
    monkeypatch.chdir(EXAMPLES.parent)
    monkeypatch.setattr(sys, "path", list(sys.path))
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out


@pytest.mark.parametrize("name,argv,want", [
    ("torch_quickstart", [], QUICKSTART),
    ("torch_lambda_tradeoff", [], LAMBDA_TRADEOFF),
    ("torch_energy_budget", ["--per-task", "120"], None),
    ("torch_energy_budget", ["--carbon", "--per-task", "40"], None),
], ids=["quickstart", "lambda_tradeoff", "energy_budget",
        "energy_budget_carbon"])
def test_sim_example_prints_the_references_numbers(name, argv, want,
                                                   monkeypatch, capsys):
    """``want`` None: the reference script runs here, with ``argv``."""
    if want is None:
        want = _reference_output(name.removeprefix("torch_"), argv,
                                 monkeypatch, capsys)
    _example(name).main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert _deterministic(got) == _deterministic(want)
    assert len(_deterministic(want)) >= 7


def test_examples_default_to_the_card(monkeypatch):
    """With no ``--device`` a twin builds its router on the card, and
    where there is none it refuses to run (``device.resolve_device``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _example("torch_quickstart").main([])


def test_serve_pool_routes_as_the_reference(monkeypatch, capsys,
                                            equal_energy_constants):
    made = []

    class Recording(repro.serving.PoolServer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    jax_get_config = functools.partial(repro.configs.get_config, **F32)
    monkeypatch.setattr(repro.serving, "PoolServer", Recording)
    monkeypatch.setattr(repro.configs, "get_config", jax_get_config)
    monkeypatch.setattr(repro.launch.serve, "get_config", jax_get_config)
    monkeypatch.setattr(sys, "argv", ["serve_pool.py", "--queries", "8"])
    runpy.run_path(str(EXAMPLES / "serve_pool.py"), run_name="__main__")
    want_out = capsys.readouterr().out
    want = made[0]
    assert list(want.engines) == ["rwkv6-1.6b", "qwen2-moe-a2.7b",
                                  "granite-3-8b"]

    weights = {}
    for arch, eng in want.engines.items():
        cfg = get_config(arch, smoke=True, vocab_size=eng.cfg.vocab_size,
                         max_seq_len=eng.cfg.max_seq_len, **F32)
        model = params_from_jax(jax.tree.map(np.asarray, eng.params), cfg,
                                device="cpu")
        weights[arch] = (model, cfg)
    run = _example("torch_serve_pool").main(
        ["--queries", "8", "--device", "cpu"], weights=weights)
    got_out = capsys.readouterr().out
    got = run["server"]
    assert sorted(got.responses) == sorted(want.responses) == sorted(
        q.uid for q in run["queries"])
    for uid, r in want.responses.items():
        assert got.responses[uid].model_name == r.model_name
        assert got.responses[uid].tokens == list(r.tokens)
    assert got.stats == want.stats
    assert got.stats["hedges"] > 0
    assert list(got.engines) == list(want.engines)
    assert got.router.selection_counts().tolist() == \
        np.asarray(want.router.selection_counts()).tolist()

    def lines(out):       # the routed counts and the addition, not times
        return [l for l in out.splitlines()
                if "routed" in l or l.startswith("[t=")]

    assert lines(got_out) == lines(want_out)
    assert len(lines(got_out)) == 4
