"""Disaggregated prefill/decode serving in the port on the CPU against the
JAX package: the cases of ``tests/test_disagg.py`` (granite-3-8b,
qwen2-moe-a2.7b and whisper-medium, whose migration moves the decoder's
self K/V) at smoke size in fp32, the JAX weights carried by
``params_from_jax`` and the port's energy constants set to the JAX
package's.

  * a prefill engine plus a decode twin generates the tokens a unified
    engine does, and the JAX package's disaggregated pool's, with the
    same migrations and the same per-response Wh, prefill Wh and
    migrated lengths (1e-12), and the migrated K/V is the prefill slot's
    prompt region, bit for bit;
  * rwkv6 refuses the prefill role and serves unified;
  * the migration's energy and fields: each ledger sums, the twin's
    prefill ledger is its migration transfers, equal to the JAX
    package's (1e-12);
  * killing the prefill engine mid-migration, and the decode twin
    mid-stream: every request answered, the JAX package's answers;
  * ``run_until_drained`` raises on live work, then drains;
  * seeded and planned interleavings of arrivals and kills: nothing lost
    or duplicated, every ledger consistent;
  * ``benchmarks/disagg.py``'s ``main`` at 24 users equal to the JAX
    package's ``bench_disagg.main`` (its artifact, 1e-12).

The JAX side runs once per module (``jax_runs``)."""
import functools
import json
import types

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from benchmarks import bench_disagg as jax_disagg
from repro.configs import get_config as jax_get_config
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import Query as JaxQuery
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.data import tokenizer as jax_tok
from repro.models import api as jax_api
from repro.serving import ModelEngine as JaxModelEngine
from repro.serving import PoolServer as JaxPoolServer
from repro_torch.benchmarks import disagg
from repro_torch.configs import get_config
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Query, RouterConfig
from repro_torch.data import tokenizer as tok
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import LivelockError, ModelEngine, PoolServer, Request
from test_torch_costmodel import assert_close, one_torch_thread  # noqa: F401
from test_torch_serving import equal_energy_constants  # noqa: F401

pytestmark = [pytest.mark.port, pytest.mark.disagg]

MAX_LEN = 48
CHUNK = 4
EXACT = 1e-12
ARCHS = ["granite-3-8b", "qwen2-moe-a2.7b", "whisper-medium"]
F32 = dict(smoke=True, vocab_size=tok.VOCAB_SIZE, dtype="float32",
           kv_update="where")

JAX = types.SimpleNamespace(Router=JaxRouter, RouterConfig=JaxRouterConfig,
                            ModelPool=JaxModelPool, Query=JaxQuery,
                            PoolServer=JaxPoolServer, encode=jax_tok.encode,
                            router_kw={})
PORT = types.SimpleNamespace(Router=GreenServRouter, RouterConfig=RouterConfig,
                             ModelPool=ModelPool, Query=Query,
                             PoolServer=PoolServer, encode=tok.encode,
                             router_kw=dict(device="cpu"))


@functools.lru_cache(maxsize=None)
def _weights(arch: str, seed: int = 0):
    """(JAX params, the same weights in the port) of the fp32 smoke
    model the reference's ``_build_pair`` initialises."""
    params = jax_api.init_params(jax_get_config(arch, **F32),
                                 jax.random.PRNGKey(seed))
    return params, params_from_jax(jax.tree.map(np.asarray, params),
                                   get_config(arch, **F32), device="cpu")


def _build_pair(ns, arch, seed=0, max_batch=2):
    """(prefill-capable engine, decode twin sharing its params)."""
    jparams, model = _weights(arch, seed)
    kw = dict(max_batch=max_batch, max_len=MAX_LEN, prefill_chunk=CHUNK)
    if ns is JAX:
        cfg, key = jax_get_config(arch, **F32), jax.random.PRNGKey(seed)
        eng = JaxModelEngine(arch, cfg, key, params=jparams, **kw)
        return eng, JaxModelEngine(arch, cfg, key, params=eng.params,
                                   role="decode", **kw)
    cfg = get_config(arch, **F32)
    eng = ModelEngine(arch, cfg, seed, params=model, device="cpu", **kw)
    return eng, ModelEngine(arch, cfg, seed, params=eng.params,
                            role="decode", device="cpu", **kw)


def _server(ns, eng, twin=None):
    router = ns.Router(ns.RouterConfig(lam=0.4, energy_scale_wh=0.05),
                       ns.ModelPool([eng.profile]), **ns.router_kw)
    return ns.PoolServer(router, {eng.name: eng}, tokenizer=ns.encode,
                         prefill_chunk=CHUNK,
                         decode_engines={eng.name: twin} if twin else None)


def _queries(ns, n, seed=0, max_new=(2, 6)):
    rng = np.random.default_rng(seed)
    return [ns.Query(uid=i,
                     text=f"probe {i} " + "ctx " * int(rng.integers(1, 7)),
                     max_new_tokens=int(rng.integers(*max_new)))
            for i in range(n)]


def _drain(server, queries):
    for q in queries:
        server.enqueue(q)
        server.step()
    server.run_until_drained(max_steps=2_000)
    return server.responses


def _summary(server, *engines) -> dict:
    """What both packages must agree on after a run."""
    return {
        "responses": {uid: {"tokens": list(r.tokens),
                            "energy_wh": float(r.energy_wh),
                            "prefill_wh": float(r.prefill_wh),
                            "kv_migrated": int(r.kv_migrated),
                            "prefix_reused": int(r.prefix_reused),
                            "input_tokens": int(r.input_tokens),
                            "output_tokens": int(r.output_tokens)}
                      for uid, r in sorted(server.responses.items())},
        "stats": dict(server.stats),
        "phases": [{k: float(v) for k, v in
                    e.cumulative_joules_by_phase().items()}
                   for e in engines],
        "migration_joules": [float(getattr(e, "_migration_joules", 0.0))
                             for e in engines]}


# -- the JAX side, once per module ---------------------------------------


def _equivalence(ns, arch):
    uni, _ = _build_pair(ns, arch)
    uni_srv = _server(ns, uni)
    _drain(uni_srv, _queries(ns, 6, seed=3))
    eng, twin = _build_pair(ns, arch)
    srv = _server(ns, eng, twin)
    _drain(srv, _queries(ns, 6, seed=3))
    return {"unified": _summary(uni_srv, uni),
            "disaggregated": _summary(srv, eng, twin)}


def _accounting(ns):
    eng, twin = _build_pair(ns, "granite-3-8b")
    srv = _server(ns, eng, twin)
    _drain(srv, _queries(ns, 5, seed=7))
    return _summary(srv, eng, twin)


def _kill(ns, which):
    """The reference's two kill cases: the prefill engine once a migration
    has happened, or the decode twin once it holds a slot."""
    eng, twin = _build_pair(ns, "granite-3-8b")
    srv = _server(ns, eng, twin)
    seed, max_new = (11, (3, 8)) if which == "prefill" else (13, (4, 9))
    queries = _queries(ns, 8, seed=seed, max_new=max_new)
    for q in queries:
        srv.enqueue(q)
    killed_at, before = None, 0.0
    for step in range(2_000):
        srv.step()
        due = (srv.stats["migrations"] > 0 and srv.inflight
               if which == "prefill"
               else any(s is not None for s in twin.slots))
        if killed_at is None and due:
            before = eng.cumulative_joules() + twin.cumulative_joules()
            (eng if which == "prefill" else twin).inject_failure()
            killed_at = step
        if not srv.inflight and not srv.arrivals:
            break
    out = _summary(srv, eng, twin)
    out.update(killed_at=killed_at, n=len(queries), before=before,
               after=eng.cumulative_joules() + twin.cumulative_joules())
    return out


def _bench_main(module, path, n_users=24, **kw):
    module.main(n_users=n_users, artifact=str(path), **kw)
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    out = {arch: _equivalence(JAX, arch) for arch in ARCHS}
    out["accounting"] = _accounting(JAX)
    out["kill_prefill"] = _kill(JAX, "prefill")
    out["kill_decode"] = _kill(JAX, "decode")
    out["bench"] = _bench_main(
        jax_disagg, tmp_path_factory.mktemp("jax") / "disagg.json")
    return out


# -- equivalence: disaggregated == unified == the JAX package ------------


@pytest.mark.parametrize("arch", ARCHS)
def test_disagg_token_identical_to_unified(arch, jax_runs,
                                           equal_energy_constants):
    got = _equivalence(PORT, arch)
    want = jax_runs[arch]
    uni, dis = got["unified"], got["disaggregated"]
    assert list(dis["responses"]) == list(uni["responses"]) == list(range(6))
    for uid, r in uni["responses"].items():
        assert dis["responses"][uid]["tokens"] == r["tokens"], uid
    assert dis["stats"]["migrations"] > 0
    assert any(r["kv_migrated"] > 0 for r in dis["responses"].values())
    # the role split happened: the prefill engine never decoded, the twin
    # did (its prefill ledger holds only the migrations)
    assert dis["phases"][0]["decode"] == 0
    assert dis["phases"][1]["decode"] > 0
    assert_close(got, want, EXACT)


def test_migrated_kv_is_the_prefill_slots_prompt_region():
    """The payload is a copy of the slot's [0, n_prompt) K/V at the phase
    boundary, bit for bit — not a view: the next tick rewrites the freed
    slot and the payload stays as it was — and the twin's slot holds it
    after the splice."""
    eng, twin = _build_pair(PORT, "granite-3-8b")
    eng.set_role("prefill")
    first = _queries(PORT, 1, seed=5)[0]
    # a second prompt that differs from its first token on, so the tick
    # that admits it rewrites every position it feeds
    second = Query(uid=1, text="zebra crossing at dawn", max_new_tokens=4)
    req = Request(query=first, prompt_tokens=tok.encode(first.text),
                  max_new_tokens=4)
    eng.submit(req)
    out = []
    while not out:
        eng.step()
        out = eng.drain_migrations()
    n_p = len(req.prompt_tokens)
    k, v = out[0].kv_payload
    assert out[0] is req and req.kv_migrated == n_p
    assert torch.equal(k, eng.cache["k"][:, 0, :n_p])
    assert torch.equal(v, eng.cache["v"][:, 0, :n_p])
    held = (k.clone(), v.clone())
    eng.submit(Request(query=second, prompt_tokens=tok.encode(second.text),
                       max_new_tokens=4))
    eng.step()                             # rewrites slot 0
    assert not torch.equal(eng.cache["k"][:, 0, :n_p], held[0])
    assert torch.equal(k, held[0]) and torch.equal(v, held[1])
    twin.submit_migrated(req)
    twin.step()
    assert torch.equal(twin.cache["k"][:, 0, :n_p], held[0])
    assert torch.equal(twin.cache["v"][:, 0, :n_p], held[1])
    assert int(twin.cache["length"][0]) == n_p + 1


def test_recurrent_layout_falls_back_to_unified():
    """rwkv has no positional KV to export — the primary refuses the
    prefill role, the twin is never registered, serving stays unified."""
    cfg = get_config("rwkv6-1.6b", **F32)
    eng = ModelEngine("rwkv6-1.6b", cfg, 0, max_batch=2, max_len=MAX_LEN,
                      prefill_chunk=CHUNK, device="cpu")
    twin = ModelEngine("rwkv6-1.6b", cfg, 0, max_batch=2, max_len=MAX_LEN,
                       params=eng.params, role="decode", device="cpu")
    assert twin.role == "unified"
    srv = _server(PORT, eng, twin)
    assert eng.role == "unified"
    assert not srv.decode_engines
    got = _drain(srv, _queries(PORT, 4, seed=1))
    assert len(got) == 4
    assert srv.stats["migrations"] == 0
    assert all(r.kv_migrated == 0 for r in got.values())


# -- migration accounting -------------------------------------------------


def test_migration_energy_and_field_accounting(jax_runs,
                                               equal_energy_constants):
    got = _accounting(PORT)
    assert len(got["responses"]) == 5
    for r in got["responses"].values():
        assert r["energy_wh"] > 0
        assert r["output_tokens"] == len(r["tokens"]) >= 1
        assert 0 <= r["kv_migrated"] <= r["input_tokens"]
    # the twin's prefill-ledger entry is exactly the migration transfer —
    # phase-boundary overhead is charged to prefill, never to decode
    assert got["phases"][1]["prefill"] == pytest.approx(
        got["migration_joules"][1], rel=EXACT)
    assert got["migration_joules"][1] > 0
    assert_close(got, jax_runs["accounting"], EXACT)


def test_engine_phase_ledgers_sum_to_the_meter():
    eng, twin = _build_pair(PORT, "granite-3-8b")
    _drain(_server(PORT, eng, twin), _queries(PORT, 5, seed=7))
    for e in (eng, twin):
        phases = e.cumulative_joules_by_phase()
        assert phases["prefill"] + phases["decode"] == pytest.approx(
            e.cumulative_joules(), rel=EXACT)


# -- fault injection ------------------------------------------------------


@pytest.mark.parametrize("which", ["prefill", "decode"])
def test_kill_mid_stream(which, jax_runs, equal_energy_constants):
    """The prefill engine dies with requests split across both engines
    (after a migration), or the decode twin with requests decoding on it:
    everything re-queues and completes, already-charged joules stay spent
    and redone work is re-charged — the JAX package's answers."""
    got = _kill(PORT, which)
    assert got["killed_at"] is not None, "stream drained before the kill"
    assert got["stats"]["restarts"] >= 1
    assert len(got["responses"]) == got["n"]
    assert all(r["energy_wh"] > 0 for r in got["responses"].values())
    assert got["after"] >= got["before"]
    assert_close(got, jax_runs[f"kill_{which}"], EXACT)


# -- drain honesty --------------------------------------------------------


def test_run_until_drained_raises_on_live_work():
    eng, twin = _build_pair(PORT, "granite-3-8b")
    srv = _server(PORT, eng, twin)
    srv.enqueue(_queries(PORT, 1)[0])
    with pytest.raises(LivelockError) as exc:
        srv.run_until_drained(max_steps=0)
    assert isinstance(exc.value, TimeoutError)
    srv.run_until_drained()
    assert len(srv.responses) == 1


# -- arbitrary interleavings of arrivals and kills -------------------------


@pytest.fixture(scope="module")
def shared_pair():
    """One engine pair for every plan; each plan hard-resets it
    (``restart`` clears all per-request state; the meters stay
    monotone, the production restart contract)."""
    return _build_pair(PORT, "granite-3-8b")


def _run_interleaving(eng, twin, plan):
    eng.restart()
    twin.restart()
    srv = _server(PORT, eng, twin)
    uid, completions, expected = 0, [], []
    joules_floor = 0.0
    for arrivals, kill in plan:
        for words, max_new in arrivals:
            srv.enqueue(Query(uid=uid, text=f"u{uid} " + "tok " * words,
                              max_new_tokens=max_new))
            expected.append(uid)
            uid += 1
        if kill == "prefill" and (srv.inflight or srv.arrivals):
            eng.inject_failure()
        elif kill == "decode" and srv.inflight:
            twin.inject_failure()
        completions += [r.uid for r in srv.step()]
        total = eng.cumulative_joules() + twin.cumulative_joules()
        assert total >= joules_floor       # energy is never un-spent
        joules_floor = total
    for _ in range(2_000):
        if not srv.inflight and not srv.arrivals:
            break
        completions += [r.uid for r in srv.step()]
    # no request lost, duplicated, or completed twice
    assert sorted(completions) == sorted(expected)
    assert set(srv.responses) == set(expected)
    for r in srv.responses.values():
        assert r.energy_wh > 0
        assert r.output_tokens == len(r.tokens) >= 1
        assert 0 <= r.prefix_reused < max(r.input_tokens, 1)
        assert 0 <= r.kv_migrated <= r.input_tokens
    for e in (eng, twin):
        phases = e.cumulative_joules_by_phase()
        assert phases["prefill"] + phases["decode"] == pytest.approx(
            e.cumulative_joules())


_KILLS = ["none", "none", "none", "prefill", "decode"]


@pytest.mark.parametrize("seed", range(4))
def test_no_request_lost_or_duplicated_seeded(shared_pair, seed):
    eng, twin = shared_pair
    rng = np.random.default_rng(seed)
    plan = [([(int(rng.integers(1, 9)), int(rng.integers(1, 6)))
              for _ in range(int(rng.integers(0, 3)))],
             _KILLS[int(rng.integers(0, len(_KILLS)))])
            for _ in range(int(rng.integers(4, 15)))]
    _run_interleaving(eng, twin, plan)


# plans the reference's property search reaches: a kill on the very tick
# of an arrival, both engines in one window, back-to-back kills, and a
# one-token budget (finishes at its first token, never migrates)
PLANS = {
    "kill_on_arrival": [([(3, 4)], "prefill"), ([(5, 2)], "none"),
                        ([], "decode"), ([(8, 5)], "none")],
    "both_in_one_window": [([(6, 5), (2, 3)], "none"), ([], "prefill"),
                           ([], "decode"), ([(4, 4)], "none"),
                           ([], "none")],
    "back_to_back": [([(7, 5), (7, 5)], "none"), ([], "decode"),
                     ([], "decode"), ([], "prefill"), ([], "prefill"),
                     ([(1, 1)], "none")],
    "one_token_budgets": [([(2, 1), (8, 1)], "none"), ([(5, 1)], "decode"),
                          ([], "none"), ([(3, 2)], "prefill")],
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_no_request_lost_or_duplicated_planned(shared_pair, name):
    eng, twin = shared_pair
    _run_interleaving(eng, twin, PLANS[name])


# -- the bench -------------------------------------------------------------


def test_bench_main_matches_jax(jax_runs, tmp_path, monkeypatch,
                                equal_energy_constants):
    """``disagg.main`` at 24 users (monolithic 2B slots vs the pair) on
    the JAX package's weights: the same artifact — TTFT percentiles on
    the virtual clock, joules, migrations, role and phase Wh and the
    trajectories — within 1e-12."""
    _, model = _weights("granite-3-8b")

    def engine(arch, cfg, seed=0, params=None, **kw):
        return ModelEngine(arch, cfg, seed,
                           params=model if params is None else params, **kw)

    monkeypatch.setattr(disagg, "ModelEngine", engine)
    got = _bench_main(disagg, tmp_path / "disagg.json", device="cpu")
    runs = got["runs"]
    assert runs["monolithic"]["completed"] == runs["disaggregated"][
        "completed"] == 24
    assert runs["disaggregated"]["migrations"] > 0
    assert runs["monolithic"]["migrations"] == 0
    assert_close(got, jax_runs["bench"], EXACT)
