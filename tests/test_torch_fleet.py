"""The port's fleet on the CPU against the JAX package: shard planning and
``base_model_name``, the feedback all-reduce (the exact merge within
``tests/test_fleet.py``'s tolerances of the JAX package's merged
statistics, identical probe arms, float32 write-back, the checkpoint
round trip), the controller's fail-over on a two-shard fleet of 120
queries (stats, events and trajectory equal to the JAX package's), the
fleet checkpoint (restored fleets route like the saved one, and a JAX
fleet's checkpoint loads into the port), heartbeats on the virtual
clock, the refusal without CUDA, the meshes, and ``pool_scale.main``'s smoke
run equal to ``benchmarks/bench_pool_scale.py``'s; and the bandit
update, which the merged replicas' near ties make decisive, rounding as
the JAX package's bit for bit.  The routers are on the CPU; their
decision timers are a fake clock in both packages, so the bench's
wall-clock overhead assertion cannot flake."""
import json
import re
import time
import types

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.core.router as jax_router_module
import repro.fleet as jax_fleet
from benchmarks import bench_pool_scale as jax_pool_scale
from repro.configs.pool import build_paper_pool as jax_build_paper_pool
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.router import GreenServRouter as JaxRouter
from repro.core.types import Feedback as JaxFeedback
from repro.core.types import ModelProfile as JaxModelProfile
from repro.core.types import RouterConfig as JaxRouterConfig
from repro.data.profiles import OutcomeSimulator as JaxOutcomeSimulator
from repro.data.scenarios import poisson_arrivals as jax_poisson_arrivals
from repro.data.stream import make_stream as jax_make_stream
from repro.serving.engine import SimEngine as JaxSimEngine
import repro_torch.core.router as router_module
import repro_torch.fleet as fleet
from repro_torch.benchmarks import pool_scale
from repro_torch.configs.pool import build_paper_pool
from repro_torch.core.pool import ModelPool
from repro_torch.core.router import GreenServRouter
from repro_torch.core.types import Feedback, ModelProfile, RouterConfig
from repro_torch.data.profiles import OutcomeSimulator
from repro_torch.data.scenarios import poisson_arrivals
from repro_torch.data.stream import make_stream
from repro_torch.serving.engine import SimEngine
from test_torch_costmodel import assert_close, one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.port, pytest.mark.fleet]

CPU = torch.device("cpu")

JAX = types.SimpleNamespace(
    fleet=jax_fleet, Router=JaxRouter, RouterConfig=JaxRouterConfig,
    ModelPool=JaxModelPool, ModelProfile=JaxModelProfile,
    Feedback=JaxFeedback, build_paper_pool=jax_build_paper_pool,
    OutcomeSimulator=JaxOutcomeSimulator, SimEngine=JaxSimEngine,
    make_stream=jax_make_stream, poisson_arrivals=jax_poisson_arrivals,
    router_kw={}, devices=None)
PORT = types.SimpleNamespace(
    fleet=fleet, Router=GreenServRouter, RouterConfig=RouterConfig,
    ModelPool=ModelPool, ModelProfile=ModelProfile, Feedback=Feedback,
    build_paper_pool=build_paper_pool, OutcomeSimulator=OutcomeSimulator,
    SimEngine=SimEngine, make_stream=make_stream,
    poisson_arrivals=poisson_arrivals, router_kw=dict(device="cpu"),
    devices=[CPU])


def _json(x):
    """numpy scalars and tuples as JSON has them."""
    return json.loads(json.dumps(x, default=float))


def _pool(ns, n=4):
    return ns.ModelPool([ns.ModelProfile(name=f"m{i}", family="t",
                                         params_b=float(i + 1),
                                         ms_per_token=float(i + 1),
                                         prefill_ms=10.0)
                         for i in range(n)])


def _queries(ns, n, seed=0):
    return ns.make_stream(per_task=max(1, n // 5 + 1), seed=seed)[:n]


def _drive(ns, router, queries, accs=None):
    """Route + close the loop for every query; the arms in order."""
    arms = []
    for i, q in enumerate(queries):
        d = router.route(q)
        acc = accs[i] if accs is not None else 0.5 + 0.4 * (i % 2)
        router.feedback(ns.Feedback(query_uid=q.uid,
                                    model_index=d.model_index, accuracy=acc,
                                    energy_wh=0.02 + 0.01 * i,
                                    latency_ms=25.0))
        arms.append(d.model_index)
    return arms


# ---------------------------------------------------------------------------
# planning
# ---------------------------------------------------------------------------


class _FakeDevice:
    def __init__(self, id):  # noqa: A002 - a device's attribute name
        self.id = id


def _shards(plan):
    return [(s.index, s.name, s.device_ids, s.models, s.n_devices)
            for s in plan.shards]


@pytest.mark.parametrize("n_shards,n_devices", [(4, 8), (3, 1), (2, 3),
                                                (1, 2)])
def test_plan_fleet_matches_jax(n_shards, n_devices):
    """Round-robin partitions (disjoint and covering where the devices
    suffice, shared by index modulo their count where they do not), the
    same in both packages; ``torch.device``s plan as their indices."""
    devices = [_FakeDevice(i) for i in range(n_devices)]
    want = jax_fleet.plan_fleet(n_shards, ["a", "b"], devices=devices)
    got = fleet.plan_fleet(n_shards, ["a", "b"], devices=devices)
    assert got.n_shards == want.n_shards == n_shards
    assert _shards(got) == _shards(want)
    by_index = fleet.plan_fleet(n_shards, ["a", "b"], devices=[
        torch.device("cuda", i) for i in range(n_devices)])
    assert _shards(by_index) == _shards(want)
    if n_devices >= n_shards:
        seen = [i for s in got.shards for i in s.device_ids]
        assert sorted(seen) == list(range(n_devices))


def test_plan_fleet_refusals(monkeypatch):
    for ns in (JAX, PORT):
        with pytest.raises(ValueError):
            ns.fleet.plan_fleet(0, ["a"], devices=[_FakeDevice(0)])
        with pytest.raises(ValueError):
            ns.fleet.plan_fleet(2, [], devices=[_FakeDevice(0)])
    # the visible CUDA devices or nothing: no CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet.plan_fleet(2, ["a"])
    plan = fleet.plan_fleet(2, ["a"], devices=[CPU])
    assert [s.device_ids for s in plan.shards] == [(0,), (0,)]
    # the meshes: (n, 1) over each shard's devices, shared ids included
    assert plan.shard_mesh(plan.shards[0]).shape == {"data": 1, "model": 1}
    assert plan.fleet_mesh().devices.tolist() == [[0], [0]]
    assert plan.fleet_mesh().device == CPU


def test_base_model_name():
    for name in ("qwen2.5-3b", "qwen2.5-3b@shard1", "m@a@b", ""):
        assert (fleet.base_model_name(name)
                == jax_fleet.base_model_name(name))
    assert fleet.base_model_name("qwen2.5-3b@shard1") == "qwen2.5-3b"
    assert fleet.TransferLedger().snapshot() == {"h2d": 0, "d2h": 0}


# ---------------------------------------------------------------------------
# the feedback all-reduce
# ---------------------------------------------------------------------------


def _replica(ns, seed=11):
    return ns.Router(ns.RouterConfig(max_arms=16, seed=seed, lam=0.4),
                     _pool(ns), **ns.router_kw)


def _merged(ns):
    """Two replicas route the same stream, each takes half the feedback,
    then one all-reduce: (pre-sync stats, post-sync bandit states, the
    report, the replicas)."""
    r1, r2 = _replica(ns), _replica(ns)
    qs = _queries(ns, 30)
    for i, q in enumerate(qs):
        d1, d2 = r1.route(q), r2.route(q)
        r, d = (r1, d1) if i < 15 else (r2, d2)
        r.feedback(ns.Feedback(query_uid=q.uid, model_index=d.model_index,
                               accuracy=0.3 + 0.02 * i, energy_wh=0.03,
                               latency_ms=20.0))
    lam_reg, dim = r1.config.lambda_reg, r1.config.context_dim
    eye = lam_reg * np.eye(dim)
    n = len(r1.pool)
    pre = []
    for r in (r1, r2):
        sd = r.policy.state_dict()
        pre.append({"xxt": np.asarray(sd["A"][:n], np.float64) - eye,
                    "b": np.asarray(sd["b"][:n], np.float64),
                    "counts": np.asarray(sd["counts"][:n], np.float64)})
    ar = ns.fleet.FeedbackAllReduce(lam_reg, dim)
    report = ar.sync({"s0": r1, "s1": r2})
    post = [{k: np.array(v) for k, v in r.policy.state_dict().items()}
            for r in (r1, r2)]
    return pre, post, report, (r1, r2), ar


def test_allreduce_exact_merge():
    """After a sync every replica's arm statistics are the sum of both
    replicas' updates (``tests/test_fleet.py``'s tolerances), the port's
    merged statistics are the JAX package's within those tolerances,
    written back in float32, a second sync is a no-op, and the merged
    replicas of both packages pick the same probe arms."""
    jpre, jpost, jreport, jr, _ = _merged(JAX)
    pre, post, report, (r1, r2), ar = _merged(PORT)
    assert report == jreport and report["arms_updated"] == 2 * 4
    lam_reg, dim = r1.config.lambda_reg, r1.config.context_dim
    eye = lam_reg * np.eye(dim)
    expected_A = eye + pre[0]["xxt"] + pre[1]["xxt"]
    for sd, jsd in zip(post, jpost):
        for got, want in ((sd, jsd["A"][:4]), (sd, expected_A)):
            np.testing.assert_allclose(got["A"][:4], want, rtol=1e-4,
                                       atol=1e-5)
        for want in (jsd["b"][:4], pre[0]["b"] + pre[1]["b"]):
            np.testing.assert_allclose(sd["b"][:4], want, rtol=1e-4,
                                       atol=1e-5)
        for want in (jsd["counts"][:4],
                     pre[0]["counts"] + pre[1]["counts"]):
            np.testing.assert_allclose(sd["counts"][:4], want, rtol=1e-5)
        for want in (jsd["A_inv"][:4], np.linalg.inv(expected_A)):
            np.testing.assert_allclose(sd["A_inv"][:4], want, rtol=1e-3,
                                       atol=1e-4)
        assert all(sd[k].dtype == np.float32
                   for k in ("A", "A_inv", "b", "theta"))
        np.testing.assert_array_equal(sd["key"], jsd["key"])
    before = np.array(r1.policy.state_dict()["A"][:4])
    ar.sync({"s0": r1, "s1": r2})
    np.testing.assert_allclose(r1.policy.state_dict()["A"][:4], before,
                               rtol=1e-6)
    probe = _queries(PORT, 10, seed=9)
    arms = [[d.model_index for d in r.route_batch(probe)] for r in (r1, r2)]
    jprobe = _queries(JAX, 10, seed=9)
    jarms = [[d.model_index for d in r.route_batch(jprobe)] for r in jr]
    assert arms[0] == arms[1] == jarms[0] == jarms[1]


def test_allreduce_checkpoint_roundtrip():
    def case(ns):
        r1, r2 = _replica(ns), _replica(ns)
        _drive(ns, r1, _queries(ns, 10, seed=1))
        _drive(ns, r2, _queries(ns, 10, seed=2))
        ar = ns.fleet.FeedbackAllReduce(r1.config.lambda_reg,
                                        r1.config.context_dim)
        ar.sync({"s0": r1, "s1": r2})
        ar2 = ns.fleet.FeedbackAllReduce(r1.config.lambda_reg,
                                         r1.config.context_dim)
        ar2.load_state_dict(ar.state_dict())
        assert ar2.syncs == ar.syncs
        for base, stats in ar._global.items():
            for k, v in stats.items():
                np.testing.assert_allclose(ar2._global[base][k], v)
        return _json({"global": {b: {k: v.tolist() for k, v in s.items()}
                                 for b, s in ar2._global.items()},
                      "snap": sorted(ar2._snap), "syncs": ar2.syncs})

    assert_close(case(PORT), case(JAX), 1e-12)


# ---------------------------------------------------------------------------
# the controller: fail-over and checkpoints through the closed loop
# ---------------------------------------------------------------------------

SMALL_EXCLUDE = ["yi-34b", "gemma-3-27b", "qwen2.5-14b", "phi-4-14b",
                 "gemma-3-12b", "llama-3.1-8b", "qwen2.5-7b", "mistral-7b",
                 "qwen2.5-3b", "gemma-3-4b", "llama-3.2-3b",
                 "phi-4-mini-4b"]


def _small_fleet(ns, n_shards, clk, seed=0, heartbeat_timeout_s=0.3):
    """``tests/test_fleet.py``'s fleet: a 4-model paper-pool subset on
    ``SimEngine``s per shard, sync every 4 ticks."""
    clock = lambda: clk["t"]  # noqa: E731
    sim = ns.OutcomeSimulator(seed=seed)
    outcome = lambda q, m: sim(q, ns.fleet.base_model_name(m))  # noqa: E731
    names = [p.name for p in ns.build_paper_pool(exclude=SMALL_EXCLUDE)]
    plan = ns.fleet.plan_fleet(n_shards, names, devices=ns.devices)

    def router_factory(spec):
        cfg = ns.RouterConfig(max_arms=16, seed=seed + spec.index, lam=0.4,
                              energy_scale_wh=0.45)
        return ns.Router(cfg, ns.ModelPool(
            ns.build_paper_pool(exclude=SMALL_EXCLUDE)), **ns.router_kw)

    def engine_factory(profile, spec):
        return ns.SimEngine(profile, outcome, steps_per_query=2,
                            concurrency=4, clock=clock)

    return plan, ns.fleet.build_fleet(
        plan, router_factory, engine_factory, sync_every=4,
        heartbeat_timeout_s=heartbeat_timeout_s, clock=clock)


def _failover(ns):
    clk = {"t": 0.0}
    plan, ctrl = _small_fleet(ns, 2, clk)
    qs = _queries(ns, 120)
    arrivals = ns.poisson_arrivals(len(qs), 12.0, seed=1)
    t_kill = arrivals[len(arrivals) // 3]
    victim = plan.shards[1].name
    traj = ns.fleet.drive_fleet(
        ctrl, qs, arrivals, clk,
        events=[(t_kill, lambda: ctrl.kill_shard(victim))])
    assert ctrl.stats["completed"] == len(qs) and not ctrl.unanswered
    assert ctrl.stats["failovers"] == 1
    assert ctrl.stats["redispatched"] > 0
    assert ctrl.stats["adopted_engines"] == 4
    survivor = ctrl.shards[plan.shards[0].name]
    adopted = [n for n in survivor.server.router.pool.names if "@" in n]
    assert len(adopted) == 4
    keys = {name: np.asarray(shard.server.router.policy.state_dict()["key"])
            .tolist() for name, shard in ctrl.shards.items()}
    return _json({"stats": ctrl.stats, "events": ctrl.events,
                  "trajectory": traj, "adopted": adopted, "span": clk["t"],
                  "keys": keys,
                  "models": {uid: r.model_name
                             for uid, r in sorted(ctrl.responses.items())},
                  "dispatched": sorted(ctrl.dispatched.items())})


def test_failover_matches_jax():
    """Killing a shard mid-stream loses nothing, and the port's controller
    does it as the JAX package's does: the same stats, the same fail-over
    event (remesh None on a shared-device fleet), trajectory, adopted
    arms, final shard of every query, serving model of every response and
    every router's key."""
    want, got = _failover(JAX), _failover(PORT)
    assert got["events"][0]["remesh"] is None
    assert_close(got, want, 1e-12)


def _probe_arms(ctrl, probe):
    return {name: [d.model_index
                   for d in shard.server.router.route_batch(probe)]
            for name, shard in ctrl.shards.items()}


def test_fleet_checkpoint_roundtrip(tmp_path):
    """Fleet-wide save/restore through ``distributed.checkpoint``: a fresh
    fleet restored from the checkpoint routes exactly like the one that
    saved, shard by shard, and so does a port fleet restored from the JAX
    package's fleet checkpoint."""
    def saved(ns, d):
        clk = {"t": 0.0}
        _, ctrl = _small_fleet(ns, 2, clk)
        qs = _queries(ns, 60)
        ns.fleet.drive_fleet(ctrl, qs, ns.poisson_arrivals(len(qs), 10.0,
                                                           seed=2), clk)
        assert ctrl.stats["syncs"] > 0
        ctrl.save_checkpoint(str(d), step=1)
        return ctrl

    ctrl, jctrl = saved(PORT, tmp_path / "port"), saved(JAX, tmp_path / "jax")
    probe = _queries(PORT, 10, seed=7)
    want = _probe_arms(ctrl, probe)
    assert want == _probe_arms(jctrl, _queries(JAX, 10, seed=7))
    for d in ("port", "jax"):
        _, fresh = _small_fleet(PORT, 2, {"t": 0.0})
        assert fresh.load_checkpoint(str(tmp_path / d)) == 1
        assert _probe_arms(fresh, probe) == want
        assert fresh.allreduce.syncs == ctrl.allreduce.syncs


def test_heartbeat_virtual_clock_no_sleep():
    """``fault.Heartbeat`` takes an injectable clock: staleness follows
    modeled time, nothing sleeps."""
    def case(ns):
        t = {"now": 0.0}
        mon = ns.fleet.controller.HeartbeatMonitor(
            timeout_s=5.0, clock=lambda: t["now"])
        mon.register("s0")
        mon.register("s1")
        t["now"] = 4.0
        mon.beat("s0")
        t["now"] = 6.0
        seen = [mon.stale()]
        mon.deregister("s1")
        seen.append(mon.stale())
        t["now"] = 20.0
        seen.append(mon.stale())
        return seen

    assert case(PORT) == case(JAX) == [["s1"], [], ["s0"]]


# ---------------------------------------------------------------------------
# the pool-scale bench
# ---------------------------------------------------------------------------


def _fake_decision_clock(monkeypatch, module):
    """The router's decision timer advances 0.1 ms a reading: the bench's
    decision-overhead assertion reads host wall clock, which a loaded
    test machine moves past its 1.5x bound in either package."""
    state = {"t": 0.0}

    def perf_counter():
        state["t"] += 1e-4
        return state["t"]

    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        perf_counter=perf_counter, time=time.time, monotonic=time.monotonic))


def _no_decision_ms(lines):
    """The lines without their decision-time fields."""
    out = []
    for line in lines:
        if line[:1].isdigit():                  # n,killed,qps,span,ms,...
            parts = line.split(",")
            line = ",".join(parts[:4] + parts[5:])
        out.append(re.sub(r"overhead x[0-9.]+", "overhead x?", line))
    return out


def _no_decision_runs(artifact):
    runs = json.loads(artifact.read_text())["runs"]
    for rec in runs.values():
        rec.pop("mean_decision_ms")
    return runs


def test_pool_scale_smoke_matches_jax(tmp_path, monkeypatch):
    """``pool_scale.main(smoke=True)``: {1, 4} shards, 150 queries a
    shard, the 4-shard run with a shard killed at 40% of its arrivals —
    the bench's three assertions hold and its lines and artifact equal the
    JAX bench's but for the decision times."""
    _fake_decision_clock(monkeypatch, jax_router_module)
    _fake_decision_clock(monkeypatch, router_module)
    want = jax_pool_scale.main(smoke=True, artifact=str(tmp_path / "j.json"))
    got = pool_scale.main(smoke=True, artifact=str(tmp_path / "p.json"),
                          device="cpu")
    assert _no_decision_ms(got[:-1]) == _no_decision_ms(want[:-1])
    assert got[1].startswith("1,0,4.68,32.03,")
    assert got[2].startswith("4,1,20.46,29.32,")
    assert got[2].endswith(",600/600,59,90")
    runs = _no_decision_runs(tmp_path / "p.json")
    assert runs["shards4"]["stats"]["failovers"] == 1
    assert runs["shards4"]["stats"]["adopted_engines"] == 8
    assert_close(runs, _no_decision_runs(tmp_path / "j.json"), 1e-12)


@pytest.mark.parametrize("contexts", ["one_hot", "dense"])
def test_update_rounds_as_xla(contexts):
    """The Sherman–Morrison update is the JAX package's jitted update on
    its CPU backend bit for bit (A, A⁻¹, b, θ̂, sums, ε, t) over 300
    updates: the router's one-hot contexts and dense ones.  A θ̂ an ulp
    apart flips near ties between arms, and the fleet's all-reduce makes
    them common (two arms merged from the same few observations)."""
    from repro.core.bandits import BanditPolicy as JaxBanditPolicy
    from repro_torch.core.bandits import BanditPolicy

    rng = np.random.default_rng(3)
    jp = JaxBanditPolicy(JaxRouterConfig(max_arms=8), 5)
    pp = BanditPolicy(RouterConfig(max_arms=8), 5, device="cpu")
    for _ in range(300):
        if contexts == "one_hot":
            x = np.zeros(12, np.float32)
            x[[rng.integers(5), 5 + rng.integers(4), 9 + rng.integers(2),
               11]] = 1.0
        else:
            x = rng.standard_normal(12).astype(np.float32)
        arm, r = int(rng.integers(5)), float(rng.standard_normal())
        jp.update(arm, x, r)
        pp.update(arm, x, r)
    want, got = jp.state_dict(), pp.state_dict()
    for k in ("A", "A_inv", "b", "theta", "reward_sum", "counts", "eps",
              "t"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), k)
