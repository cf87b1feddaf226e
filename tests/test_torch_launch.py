"""The port's serving launcher (``repro_torch.launch.serve``) on the CPU:
``main`` with ``--device cpu`` over a 2-engine smoke pool (granite-3-8b
and qwen2-moe-a2.7b) and the stream's first queries (``--queries 6``:
the stream's 5 tasks, one query each, as the JAX package's launcher
draws them), with its defaults (prefix cache, cost model on, telemetry
without a governor) and with a budget, the admission planner and a
metrics dump: every query answered, every forecast reconciled, the
telemetry's Wh equal to the responses', and the dump read back by both
packages' ``load_jsonl``.  ``--disaggregate`` is refused, not ignored."""
import pytest

torch = pytest.importorskip("torch")

from repro.telemetry import load_jsonl as jax_load_jsonl
from repro_torch.launch import serve
from repro_torch.telemetry import load_jsonl
from test_torch_costmodel import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.port

POOL = ["--device", "cpu", "--pool", "granite-3-8b", "qwen2-moe-a2.7b",
        "--queries", "6"]


def _check_run(run) -> None:
    server, cm, tel = run["server"], run["cost_model"], run["telemetry"]
    queries = run["queries"]
    assert len(queries) == 5
    assert sorted(server.responses) == sorted(q.uid for q in queries)
    assert cm.n_predicted == cm.n_reconciled == len(queries)
    assert cm.inflight_predicted == 0
    served_wh = sum(r.energy_wh for r in server.responses.values())
    metered_mwh = sum(m.value for m in tel.registry
                      if m.name == "greenserv_energy_mwh_total")
    assert metered_mwh / 1e3 == pytest.approx(served_wh, rel=1e-6)
    assert tel.registry.find("greenserv_admitted_total").value == len(queries)


def test_launcher_defaults_on_the_cpu(capsys):
    run = serve.main(POOL)
    _check_run(run)
    assert run["governor"] is None
    assert run["cache"].mode == "prefix"
    out = capsys.readouterr().out
    assert "[serve] 5/5 queries" in out
    assert "5/5 forecasts reconciled" in out
    assert "[telemetry]" in out


def test_launcher_governed_with_planner_and_dump(tmp_path, capsys):
    path = tmp_path / "metrics.jsonl"
    run = serve.main(POOL + ["--energy-budget-wh", "1e-6",
                             "--admission-planner", "--cache-mode", "full",
                             "--metrics-out", str(path)])
    _check_run(run)
    gov, server = run["governor"], run["server"]
    assert gov is not None and server.telemetry.governor is gov
    assert gov.router is run["router"]
    # a budget below one query's forecast: the planner defers, and the
    # idle pool's head-of-line admission keeps it draining
    assert server.stats["deferred"] > 0
    assert gov.cumulative_wh == pytest.approx(
        sum(r.energy_wh for r in server.responses.values()), rel=1e-6)
    assert gov.prediction_error["n"] == len(run["queries"])
    out = capsys.readouterr().out
    assert "wrote" in out and str(path) in out
    for load in (load_jsonl, jax_load_jsonl):
        back = load(str(path))
        assert back["meta"][0]["queries"] == 5
        assert back["meta"][0]["budget_wh"] == 1e-6
        counters = {(r["name"], tuple(sorted(r["labels"].items()))):
                    r["value"] for r in back["counter"]}
        assert counters[("greenserv_admitted_total", ())] == 5
        kinds = {e["kind"] for e in back["event"]}
        assert {"admit", "complete", "defer"} <= kinds
        assert back["power"]


def test_launcher_refuses_disaggregation():
    with pytest.raises(NotImplementedError, match="disaggregation"):
        serve.main(POOL + ["--disaggregate"])


def test_launcher_defaults_are_the_reference_launchers():
    """The flags and defaults the JAX package's launcher parses, plus
    ``--device`` (None: the card)."""
    args = serve.build_parser().parse_args([])
    assert args.pool == ["granite-3-8b", "rwkv6-1.6b", "qwen2-moe-a2.7b"]
    assert (args.queries, args.lam, args.prefill_chunk) == (40, 0.4, 8)
    assert (args.cache_mode, args.kv_cache_blocks) == ("prefix", 512)
    assert args.semantic_threshold == 0.92 and args.semantic_ttl is None
    assert (args.featurize, args.cost_model) == ("auto", "on")
    assert args.energy_budget_wh is None and not args.admission_planner
    assert args.hedge is None and args.fail_engine is None
    assert not args.disaggregate and args.device is None
