"""The port's bench entry points on the CPU against the JAX package's
(``benchmarks/bench_*.py``, ``benchmarks/run.py``):

  * ``telemetry.main``: the ``governance,*`` lines and the governed run's
    λ history equal the JAX bench's at ``per_task`` 20 (Wh and accuracy
    within 1e-9); the overhead lines present and finite (the < 5%
    assertion is ``--smoke``'s, held on the card by ``chip_smoke.py``:
    a CPU step is not the card's); the ``--out`` dump with the JAX dump's
    rows and keys;
  * ``baselines.main`` and ``routerbench.main`` with ``--smoke``'s
    assertions at small sizes: every line and the artifact's numbers;
  * ``cache.main(smoke=True)`` on the JAX package's granite weights
    (carried by ``models/convert.py``, the port's energy constants set to
    the JAX package's): every line, the artifact and the dump's rows;
  * ``kernels.main``: the reference's header, kernels and configs, each
    error 0 (the wrappers run their plain versions on the CPU);
  * the aggregator ``run.main``: with every section's bench function
    replaced by a recorder in both aggregators, the (title, bench,
    function, kwargs) calls of the default, ``--fast`` and ``--full``
    runs equal, all 17 with the ``Roofline`` section last, apart from the
    port's ``device`` and the port's dry-run directory; a section that
    raises prints ``# FAILED`` and the port's ``main`` returns 1 after
    running every section.
"""
import importlib
import json
import math
import re
import sys

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from benchmarks import (bench_baselines, bench_cache, bench_kernels,
                        bench_routerbench, bench_telemetry)
from benchmarks import run as jax_run
from repro.core import energy as jax_energy
from repro.models import api as jax_api
from repro.telemetry import load_jsonl as jax_load_jsonl
from repro_torch.benchmarks import (baselines, cache, kernels, routerbench,
                                    telemetry)
from repro_torch.benchmarks import run as port_run
from repro_torch.core import energy as port_energy
from repro_torch.models.convert import params_from_jax
from repro_torch.telemetry import load_jsonl
from test_torch_costmodel import assert_close, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

EXACT = 1e-9
CPU = dict(device="cpu")
TEL_PER_TASK = 20
BASELINES = dict(per_task=6, closed_per_task=60, smoke=True)
ROUTERBENCH = dict(n_per_task=10, closed_n_per_task=20, smoke=True)


def _without_paths(lines):
    """A main's lines without the ``artifact,path`` / ``dump,path`` lines,
    which name each package's own file."""
    return [l for l in lines if not re.match(r"(artifact|dump),path,", l)]


# -- telemetry -------------------------------------------------------------


def _capture_governed(monkeypatch, module, runs):
    real = module.run_governed

    def governed(*args, **kwargs):
        res = real(*args, **kwargs)
        runs.append(res)
        return res

    monkeypatch.setattr(module, "run_governed", governed)


@pytest.fixture(scope="module")
def telemetry_runs(tmp_path_factory):
    """(lines, governed run, dump path) of each package's ``main``."""
    out = {}
    tmp = tmp_path_factory.mktemp("telemetry")
    for name, module, kw in (("jax", bench_telemetry, {}),
                             ("port", telemetry, CPU)):
        runs, path = [], tmp / f"{name}.jsonl"
        with pytest.MonkeyPatch.context() as mp:
            _capture_governed(mp, module, runs)
            lines = module.main(per_task=TEL_PER_TASK, out=str(path), **kw)
        out[name] = (lines, runs[0], path)
    return out


def test_telemetry_governance_matches_jax(telemetry_runs):
    (want, jres, _), (got, pres, _) = (telemetry_runs["jax"],
                                       telemetry_runs["port"])
    assert [l for l in got if l.startswith("governance,")] == [
        l for l in want if l.startswith("governance,")]
    assert len([l for l in got if l.startswith("governance,")]) == 9
    assert_close([pres.mean_accuracy, pres.total_energy_wh],
                 [jres.mean_accuracy, jres.total_energy_wh], EXACT)
    jgov, pgov = jres.telemetry.governor, pres.telemetry.governor
    assert len(pgov.lambda_history) == len(jgov.lambda_history) > 0
    # (t, λ) pairs; t is the governor's wall clock, so only λ is compared
    assert_close([float(lam) for _, lam in pgov.lambda_history],
                 [float(lam) for _, lam in jgov.lambda_history], EXACT)


def test_telemetry_overhead_lines_are_finite(telemetry_runs):
    got = telemetry_runs["port"][0]
    assert got[0] == "section,metric,value"
    rows = dict(l.split(",")[1:] for l in got if l.startswith("overhead,"))
    assert list(rows) == ["bare_step_ms", "telemetry_step_ms",
                          "overhead_pct"]
    assert all(math.isfinite(float(v)) and float(v) > 0
               for v in rows.values())


def test_telemetry_dump_matches_jax(telemetry_runs):
    (want, _, jpath), (got, _, ppath) = (telemetry_runs["jax"],
                                         telemetry_runs["port"])
    assert [l for l in got if l.startswith("dump,rows")] == [
        l for l in want if l.startswith("dump,rows")]
    assert f"dump,path,{ppath}" in got
    jdump, pdump = jax_load_jsonl(str(jpath)), load_jsonl(str(ppath))
    assert {k: len(v) for k, v in pdump.items()} == {
        k: len(v) for k, v in jdump.items()}
    for kind in jdump:
        assert [sorted(r) for r in pdump[kind]] == [
            sorted(r) for r in jdump[kind]]
    assert pdump["meta"][0]["per_task"] == TEL_PER_TASK


def test_telemetry_smoke_asserts_the_overhead(monkeypatch):
    """``--smoke`` refuses a telemetry cost of 5% of a step or more (a
    hook slowed down here makes it so)."""
    slow = telemetry.TimedTelemetry._timed

    def timed(self, fn, *a, **kw):
        slow(self, fn, *a, **kw)
        self.hook_s += 1.0

    monkeypatch.setattr(telemetry.TimedTelemetry, "_timed", timed)
    with pytest.raises(AssertionError, match="telemetry overhead"):
        telemetry.main(per_task=2, smoke=True, **CPU)


# -- baselines and RouterBench ---------------------------------------------


@pytest.mark.parametrize("name", ["baselines", "routerbench"])
def test_bench_main_matches_jax(name, tmp_path):
    """Every line (the smoke ordering line included) and the artifact's
    numbers, at sizes where ``--smoke``'s ordering holds."""
    port, ref, kw = {"baselines": (baselines, bench_baselines, BASELINES),
                     "routerbench": (routerbench, bench_routerbench,
                                     ROUTERBENCH)}[name]
    paths = {k: tmp_path / f"{k}.json" for k in ("jax", "port")}
    want = ref.main(artifact=str(paths["jax"]), **kw)
    got = port.main(artifact=str(paths["port"]), **kw, **CPU)
    assert _without_paths(got) == _without_paths(want)
    assert got[-1] == f"artifact,path,{paths['port']}"
    assert any(l.startswith("smoke,closed-loop ordering holds") for l in got)
    art, ref_art = (json.loads(paths[k].read_text()) for k in ("port", "jax"))
    assert_close(art, ref_art, EXACT)


def test_bench_smoke_refuses_a_lost_ordering(monkeypatch):
    """``--smoke`` fails when GreenServ spends more than random through
    the closed loop."""
    real = baselines.run_closed_loop

    def swapped(**kw):
        out = real(**kw)
        return {"greenserv": out["random"], "random": out["greenserv"]}

    monkeypatch.setattr(baselines, "run_closed_loop", swapped)
    with pytest.raises(AssertionError, match="GreenServ"):
        baselines.main(per_task=2, closed_per_task=60, smoke=True,
                       artifact=None, **CPU)


# -- GreenCache --------------------------------------------------------------


@pytest.fixture(scope="module")
def equal_energy_module():
    """The port's H100 energy constants set to the JAX package's for the
    module (as ``test_torch_serving.equal_energy_constants`` per test)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("PEAK_FLOPS_BF16", "HBM_BW", "CHIP_TDP_W",
                     "CHIP_IDLE_W", "E_PER_FLOP", "E_PER_HBM_BYTE"):
            mp.setattr(port_energy, name, getattr(jax_energy, name))
        mp.setattr(port_energy, "LINK_BW",
                   jax_energy.ICI_BW_PER_LINK * jax_energy.ICI_LINKS)
        mp.setattr(port_energy, "E_PER_LINK_BYTE", jax_energy.E_PER_ICI_BYTE)
        yield


def test_cache_main_matches_jax(tmp_path, equal_energy_module):
    """``main(smoke=True)`` at the CLI's 36 queries on the JAX bench's
    engine weights (``_build_pool``'s ``PRNGKey(seed + 0)`` draw): every
    mode row, the governor and carbon rows, the smoke assertions, the
    artifact within 1e-9 and the dump's rows."""
    arch, seed = "granite-3-8b", 0
    jcfg = bench_cache.get_config(arch, smoke=True,
                                  vocab_size=bench_cache.tok.VOCAB_SIZE,
                                  dtype="float32", max_seq_len=cache.MAX_LEN)
    cfg = cache.get_config(arch, smoke=True, vocab_size=cache.tok.VOCAB_SIZE,
                           dtype="float32", max_seq_len=cache.MAX_LEN)
    params = jax_api.init_params(jcfg, jax.random.PRNGKey(seed))
    weights = {arch: (params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                      device="cpu"), cfg)}
    paths = {k: (tmp_path / f"{k}.json", tmp_path / f"{k}.jsonl")
             for k in ("jax", "port")}
    want = bench_cache.main(n_queries=36, smoke=True, seed=seed,
                            artifact=str(paths["jax"][0]),
                            out=str(paths["jax"][1]))
    got = cache.main(n_queries=36, smoke=True, seed=seed,
                     artifact=str(paths["port"][0]),
                     out=str(paths["port"][1]), weights=weights, **CPU)
    assert _without_paths(got) == _without_paths(want)
    assert [l.split(",")[0] for l in got[1:3]] == ["off", "full"]
    assert [l.split(",")[1] for l in got if l.startswith("carbon,")] == [
        "run", "aware", "blind"]
    art, ref_art = (json.loads(paths[k][0].read_text())
                    for k in ("port", "jax"))
    assert_close(art, ref_art, EXACT)
    jdump, pdump = (jax_load_jsonl(str(paths["jax"][1])),
                    load_jsonl(str(paths["port"][1])))
    assert {k: len(v) for k, v in pdump.items()} == {
        k: len(v) for k, v in jdump.items()}


def test_cache_build_pool_smoke_engines():
    """Without ``weights``: the JAX bench's smoke fp32 engines at
    max_batch 4 and max_len 96, one per arch, the pool in their order."""
    engines, pool = cache.build_pool(["granite-3-8b", "qwen2-moe-a2.7b"],
                                     seed=3, **CPU)
    assert pool.names == ["granite-3-8b", "qwen2-moe-a2.7b"]
    for eng in engines.values():
        assert (eng.max_batch, eng.max_len) == (4, cache.MAX_LEN)
        assert eng.cfg.dtype == "float32" and eng.cfg.max_seq_len == 96
        assert eng.device.type == "cpu"


def test_half_day_stats_matches_jax():
    """The dirty/clean split of a governed trace, on a hand-made trace
    with a post-drain tail."""
    trace = [(0.5 * i, 0.4 + 0.01 * i, 2.0 * i) for i in range(1, 25)]
    result = {"day_s": 10.0, "trace": trace}
    assert cache._half_day_stats(result) == bench_cache._half_day_stats(
        result)


# -- kernels -----------------------------------------------------------------


def test_kernels_rows_match_the_reference():
    want = bench_kernels.main()
    got = kernels.main(**CPU)
    assert got[0] == want[0] == kernels.HEADER
    assert [l.split(",")[:2] for l in got] == [l.split(",")[:2]
                                               for l in want]
    for line in got[1:]:
        assert float(line.split(",")[2]) > 0
        assert float(line.split(",")[3]) == 0.0     # the plain version


# -- the aggregator ----------------------------------------------------------

JAX_BENCHES = {"bench_baselines": ["main"], "bench_lambda_sweep": ["main"],
               "bench_features": ["main", "perf_main"],
               "bench_model_addition": ["main"],
               "bench_routerbench": ["main"], "bench_scenarios": ["main"],
               "bench_overhead": ["main"], "bench_telemetry": ["main"],
               "bench_prefill": ["main"], "bench_cache": ["main"],
               "bench_disagg": ["main"], "bench_pool_scale": ["main"],
               "bench_energy_model": ["main"], "bench_chaos": ["main"],
               "bench_kernels": ["main"], "roofline": ["table"]}
ROOFLINE = "Roofline table (from dry-run records)"
DRYRUN_DIRS = {"experiments/dryrun": "experiments/dryrun_torch"}


def _record(monkeypatch, package: str, calls: list, fail=None):
    """Replace every section's bench function in ``package``'s aggregator
    by a recorder of (bench, function, kwargs); ``fail`` names a
    (bench, function) that raises instead."""
    for bench, fns in JAX_BENCHES.items():
        name = bench if package == "benchmarks" else bench.replace(
            "bench_", "")
        module = importlib.import_module(f"{package}.{name}")
        for fn in fns:
            def recorder(*args, _b=name.replace("bench_", ""), _f=fn,
                         **kwargs):
                if (_b, _f) == fail:
                    raise RuntimeError("boom")
                calls.append((_b, _f, args, kwargs))
                return [f"{_b}.{_f}"]
            monkeypatch.setattr(module, fn, recorder)


def _titles(out: str) -> list:
    return [m.group(1) for m in re.finditer(r"^== (.*) \([\d.]+s\) ==$", out,
                                            re.M)]


@pytest.mark.parametrize("flags", [[], ["--fast"], ["--full"]])
def test_aggregator_calls_match_the_reference(flags, monkeypatch, capsys):
    jcalls, pcalls = [], []
    _record(monkeypatch, "benchmarks", jcalls)
    _record(monkeypatch, "repro_torch.benchmarks", pcalls)
    monkeypatch.setattr(sys, "argv", ["run"] + flags)
    jax_run.main()
    jtitles = _titles(capsys.readouterr().out)
    assert port_run.main(flags + ["--device", "cpu"]) == 0
    ptitles = _titles(capsys.readouterr().out)
    assert jtitles[-1] == ROOFLINE and jcalls[-1][:2] == ("roofline",
                                                         "table")
    assert all(kw.pop("device") == "cpu" for b, _, _, kw in pcalls
               if b != "roofline")
    jcalls = [(b, f, tuple(DRYRUN_DIRS.get(a, a) for a in args), kw)
              for b, f, args, kw in jcalls]
    assert list(zip(ptitles, pcalls)) == list(zip(jtitles, jcalls))
    assert len(pcalls) == len(ptitles) == 17


def test_aggregator_failed_section_exits_nonzero(monkeypatch, capsys):
    """A section that raises prints the reference's ``# FAILED`` line,
    the later sections still run, and ``main`` returns 1."""
    calls = []
    _record(monkeypatch, "repro_torch.benchmarks", calls,
            fail=("cache", "main"))
    assert port_run.main(["--fast", "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "# FAILED: RuntimeError: boom" in out
    assert len(_titles(out)) == 17 and len(calls) == 16
    assert calls[-1][:2] == ("roofline", "table")
