"""Fleet controller: sharded engine pools behind one dispatch plane.

Topology: every shard is a full replica of the model pool — its own
``PoolServer``, its own ``GreenServRouter`` — placed on a disjoint device
group from ``plan_fleet`` (or, on one card, sharing it).  The controller
load-balances arrivals across live shards, beats each shard's heartbeat
on every controller tick, periodically all-reduces the routers' feedback
sufficient statistics (``FeedbackAllReduce`` — exact, LinUCB stats are
additive), and fails over dead shards without losing a request.

Failure semantics: ``kill_shard`` only stops a shard's clock — detection
happens through the shared ``HeartbeatMonitor`` (virtual-clock
injectable, ``distributed.fault``), exactly like a real
shard silently dropping off the network.  ``_fail_over`` then

  1. harvests completions that landed before death (responses are read
     through a per-shard ``harvested`` set, never popped — PoolServer's
     hedge-resurrection guard inspects ``server.responses``);
  2. collects every unanswered query: parked arrivals plus in-flight
     primaries (hedges are retries of a primary, not work of their own);
  3. re-registers the dead shard's engines on survivors via
     ``PoolServer.add_engine`` under ``<base>@<dead-shard>`` names —
     zero-calibration arms whose statistics the next all-reduce seeds
     from the global per-base totals;
  4. records the fail-over event, with its ``remesh`` entry: how the
     surviving chips of the fleet mesh would re-mesh
     (``distributed.elastic.plan_remesh``), or None where the fleet was
     built without meshes or the survivors cannot host the model axis;
  5. re-dispatches the collected queries to live shards.

``drive_fleet`` is the virtual-clock loop (same idle-jump discipline as
``benchmarks.common.run_scenario``) used by ``benchmarks/pool_scale.py``,
the fleet chaos variant and the fleet tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed.elastic import plan_remesh
from repro_torch.distributed.fault import HeartbeatMonitor
from repro_torch.fleet.plan import FleetPlan, ShardSpec, base_model_name
from repro_torch.fleet.sync import FeedbackAllReduce
from repro_torch.serving.scheduler import LivelockError, PoolServer


def _arrayify(tree):
    """Map python scalars in a nested dict to 0-d numpy arrays."""
    if isinstance(tree, dict):
        return {k: _arrayify(v) for k, v in tree.items()}
    if isinstance(tree, (bool, int, float)):
        return np.asarray(tree)
    return tree


class FleetShard:
    """One pool replica: spec + server + liveness + harvest bookkeeping."""

    def __init__(self, spec: ShardSpec, server: PoolServer, mesh=None):
        self.spec = spec
        self.name = spec.name
        self.server = server
        self.mesh = mesh
        self.alive = True
        # uids whose responses the controller has already read out of
        # server.responses (which is never popped — see module docstring)
        self.harvested: set = set()

    @property
    def load(self) -> int:
        return len(self.server.arrivals) + len(self.server.inflight)


class FleetController:
    """Dispatch + liveness + stat-sync + fail-over over a set of shards."""

    def __init__(self, shards: Sequence[FleetShard],
                 sync_every: int = 8,
                 heartbeat_timeout_s: float = 5.0,
                 clock: Optional[Callable[[], float]] = None,
                 engine_factory: Optional[
                     Callable[..., object]] = None,
                 fleet_mesh=None):
        if not shards:
            raise ValueError("fleet needs at least one shard")
        self.shards: Dict[str, FleetShard] = {s.name: s for s in shards}
        if len(self.shards) != len(shards):
            raise ValueError("duplicate shard names")
        self.clock = clock or time.monotonic
        self.sync_every = int(sync_every)
        self.monitor = HeartbeatMonitor(heartbeat_timeout_s,
                                        clock=self.clock)
        for s in shards:
            self.monitor.register(s.name)
        # (profile, target_shard_spec) -> engine, for fail-over adoption;
        # without it fail-over still re-dispatches, just without the
        # extra capacity
        self.engine_factory = engine_factory
        self.fleet_mesh = fleet_mesh
        cfg = shards[0].server.router.config
        self.allreduce = FeedbackAllReduce(cfg.lambda_reg, cfg.context_dim)
        self.responses: Dict[int, object] = {}
        self.dispatched: Dict[int, str] = {}     # uid -> shard name
        self.unanswered: set = set()
        # terminal failures (reliability layer): uid -> TIMED_OUT/FAILED
        # state string, harvested from each shard's ``server.failed``
        # registry exactly like responses — a terminally-failed request
        # is answered (negatively), never re-dispatched, and must not
        # hold ``drive_fleet``'s drain condition open
        self.failures: Dict[int, str] = {}
        # the controller's *belief* about routable shards: a killed shard
        # keeps receiving traffic until its heartbeat goes stale — the
        # controller has no oracle channel to the failure (queries
        # dispatched into the detection window are exactly what fail-over
        # must recover)
        self._routable: set = {s.name for s in shards}
        self.events: List[dict] = []
        self.stats = {"dispatched": 0, "redispatched": 0, "completed": 0,
                      "failed": 0, "failovers": 0, "syncs": 0,
                      "adopted_engines": 0}
        self._steps = 0

    # -- dispatch -------------------------------------------------------
    def live_shards(self) -> List[FleetShard]:
        """Shards whose process is actually running (steppable)."""
        return [s for s in self.shards.values() if s.alive]

    def routable_shards(self) -> List[FleetShard]:
        """Shards the controller *believes* are healthy — includes a dead
        shard until its heartbeat times out (see ``_routable``)."""
        return [s for s in self.shards.values() if s.name in self._routable]

    def dispatch(self, query) -> str:
        """Least-loaded believed-healthy shard (ties by shard index)."""
        routable = self.routable_shards()
        if not routable:
            raise RuntimeError("no routable shards to dispatch to")
        shard = min(routable, key=lambda s: (s.load, s.spec.index))
        shard.server.enqueue(query)
        first_time = query.uid not in self.dispatched
        self.dispatched[query.uid] = shard.name
        self.unanswered.add(query.uid)
        self.stats["dispatched" if first_time else "redispatched"] += 1
        return shard.name

    def dispatch_many(self, queries: Sequence) -> None:
        for q in queries:
            self.dispatch(q)

    # -- main loop ------------------------------------------------------
    def step(self) -> List:
        """One fleet tick: step live shards (beating their heartbeats),
        harvest fresh responses, fail over shards the monitor flags
        stale, run the periodic stat sync.  Returns fresh responses."""
        self._steps += 1
        done: List = []
        for shard in self.live_shards():
            shard.server.step()
            self.monitor.beat(shard.name)
            done.extend(self._harvest(shard))
        for name in self.monitor.stale():
            self._fail_over(self.shards[name])
        if self.sync_every and self._steps % self.sync_every == 0 \
                and len(self._sync_targets()) > 1:
            self.sync_now()
        return done

    def _sync_targets(self) -> List[FleetShard]:
        # a dead-but-undetected shard is routable but unreadable — the
        # all-reduce can only touch shards that are both
        return [s for s in self.live_shards()
                if s.name in self._routable]

    def _harvest(self, shard: FleetShard) -> List:
        fresh = []
        for uid, resp in shard.server.responses.items():
            if uid in shard.harvested:
                continue
            shard.harvested.add(uid)
            if uid in self.responses:     # answered earlier by a survivor
                continue
            self.responses[uid] = resp
            self.unanswered.discard(uid)
            self.stats["completed"] += 1
            fresh.append(resp)
        for uid, req in getattr(shard.server, "failed", {}).items():
            if uid in shard.harvested:
                continue
            shard.harvested.add(uid)
            if uid in self.responses or uid in self.failures:
                continue
            self.failures[uid] = req.state.value
            self.unanswered.discard(uid)
            self.stats["failed"] += 1
        return fresh

    # -- liveness / fail-over -------------------------------------------
    def kill_shard(self, name: str) -> None:
        """Simulate shard death: it stops stepping (and so stops beating
        its heartbeat).  Detection and recovery happen in ``step`` once
        the monitor times the shard out."""
        self.shards[name].alive = False

    def next_stale_deadline(self) -> Optional[float]:
        """Earliest virtual time a dead-but-undetected shard goes stale
        (None if all registered shards are alive) — virtual-clock loops
        jump here when live shards are idle."""
        deadlines = [hb.last_beat + self.monitor.timeout_s + 1e-6
                     for name, hb in self.monitor._beats.items()
                     if not self.shards[name].alive]
        return min(deadlines) if deadlines else None

    def _fail_over(self, dead: FleetShard) -> None:
        self.monitor.deregister(dead.name)
        dead.alive = False
        self._routable.discard(dead.name)
        survivors = self.routable_shards()
        if not survivors:
            raise RuntimeError(
                f"shard {dead.name} died with no survivors")
        srv = dead.server
        self._harvest(dead)   # completions that landed before death
        lost = list(srv.arrivals)
        lost += [req.query for uid, req in srv.inflight.items()
                 if req.hedge_of is None and uid not in self.responses
                 and uid not in self.failures]
        adopted = 0
        if self.engine_factory is not None:
            for i, member in enumerate(srv.router.pool.names):
                target = survivors[i % len(survivors)]
                profile = srv.router.pool[i]
                new_name = (f"{base_model_name(profile.name)}"
                            f"@{dead.name}")
                if new_name in target.server.engines:
                    continue   # chained failure already adopted this base
                new_profile = dataclasses.replace(profile, name=new_name)
                target.server.add_engine(
                    new_profile,
                    self.engine_factory(new_profile, target.spec))
                adopted += 1
        self.stats["adopted_engines"] += adopted
        remesh = self._remesh_record(dead)
        self.events.append({"kind": "failover", "shard": dead.name,
                            "t": self.clock(), "redispatched": len(lost),
                            "adopted_engines": adopted, "remesh": remesh})
        self.stats["failovers"] += 1
        for q in lost:
            self.dispatch(q)

    def _remesh_record(self, dead: FleetShard) -> Optional[dict]:
        """Elastic-degradation bookkeeping: how the surviving fleet chips
        would re-mesh (``distributed.elastic.plan_remesh``), recorded on
        the fail-over event.  None without a fleet mesh or where the
        survivor count can't host the model axis."""
        if self.fleet_mesh is None:
            return None
        try:
            plan = plan_remesh(self.fleet_mesh,
                               lost_chips=dead.spec.n_devices)
        except ValueError:
            return None
        return dataclasses.asdict(plan)

    # -- stat sync ------------------------------------------------------
    def sync_now(self) -> dict:
        report = self.allreduce.sync(
            {s.name: s.server.router for s in self._sync_targets()})
        self.stats["syncs"] += 1
        return report

    def set_lambda(self, lam: float) -> None:
        """Fleet-uniform scalarization: governance retunes every live
        replica together so the all-reduce merges like with like."""
        for shard in self._sync_targets():
            shard.server.router.set_lambda(lam)

    # -- telemetry ------------------------------------------------------
    def modeled_time_s(self) -> float:
        """Max modeled engine time across the whole fleet (dead shards
        included — their past work happened) — the virtual-clock pace."""
        times = [eng.modeled_time_s()
                 for shard in self.shards.values()
                 for eng in shard.server.engines.values()
                 if hasattr(eng, "modeled_time_s")]
        return max(times, default=0.0)

    def total_joules(self) -> float:
        return sum(eng.cumulative_joules()
                   for shard in self.shards.values()
                   for eng in shard.server.engines.values())

    @property
    def mean_decision_ms(self) -> float:
        """Routing overhead per query, averaged over live replicas."""
        ms = [s.server.router.mean_decision_ms
              for s in self.live_shards()
              if s.server.router.n_routed > 0]
        return sum(ms) / len(ms) if ms else 0.0

    def sample(self, t_s: float) -> dict:
        return {"t_s": round(t_s, 4),
                "completed": self.stats["completed"],
                "failed": self.stats["failed"],
                "inflight": sum(len(s.server.inflight)
                                for s in self.live_shards()),
                "parked": sum(len(s.server.arrivals)
                              for s in self.live_shards()),
                "shards_alive": len(self.live_shards()),
                "joules": round(self.total_joules(), 3)}

    # -- checkpointing --------------------------------------------------
    def state_dict(self) -> dict:
        """Fleet-wide control-plane state: every shard's full router
        state (bandit + k-means + λ), shared cost models where present,
        and the all-reduce accumulators/snapshots."""
        out = {"shards": {}, "allreduce": self.allreduce.state_dict()}
        for name, shard in self.shards.items():
            entry = {"router": shard.server.router.state_dict()}
            cm = shard.server.cost_model
            if cm is not None:
                entry["cost_model"] = cm.state_dict()
            out["shards"][name] = entry
        # distributed.checkpoint wants array leaves (restore compares
        # shapes); the routers' python int/float scalars become 0-d
        # arrays and load_state_dict's int()/float() casts take them back
        return _arrayify(out)

    def load_state_dict(self, d: Mapping) -> None:
        for name, entry in d["shards"].items():
            shard = self.shards[name]
            shard.server.router.load_state_dict(entry["router"])
            if "cost_model" in entry and shard.server.cost_model is not None:
                shard.server.cost_model.load_state_dict(
                    entry["cost_model"])
        self.allreduce.load_state_dict(d["allreduce"])

    def save_checkpoint(self, directory: str, step: int) -> str:
        return ckpt.save(directory, step, self.state_dict())

    def load_checkpoint(self, directory: str,
                        step: Optional[int] = None) -> int:
        tree, _ = ckpt.restore(directory, like=self.state_dict(),
                               step=step)
        self.load_state_dict(tree)
        loaded = step if step is not None \
            else ckpt.latest_step(directory)
        return int(loaded)


def build_fleet(plan: FleetPlan,
                router_factory: Callable[[ShardSpec], object],
                engine_factory: Callable[..., object],
                sync_every: int = 8,
                heartbeat_timeout_s: float = 5.0,
                clock: Optional[Callable[[], float]] = None,
                build_meshes: bool = False,
                server_kwargs: Optional[dict] = None) -> FleetController:
    """Wire a ``FleetController`` from a plan: one router replica + one
    ``PoolServer`` per shard, engines from ``engine_factory(profile,
    spec)``.  ``build_meshes=True`` also gives every shard its mesh and
    the controller the fleet mesh (``launch.mesh.Mesh``s over the plan's
    device ids, shared ids included), which its fail-over events' re-mesh
    records read."""
    shards = []
    for spec in plan.shards:
        router = router_factory(spec)
        engines = {p.name: engine_factory(p, spec)
                   for p in [router.pool[i]
                             for i in range(len(router.pool))]}
        server = PoolServer(router, engines, clock=clock,
                            **(server_kwargs or {}))
        mesh = plan.shard_mesh(spec) if build_meshes else None
        shards.append(FleetShard(spec, server, mesh=mesh))
    fleet_mesh = plan.fleet_mesh() if build_meshes else None
    return FleetController(shards, sync_every=sync_every,
                           heartbeat_timeout_s=heartbeat_timeout_s,
                           clock=clock, engine_factory=engine_factory,
                           fleet_mesh=fleet_mesh)


def drive_fleet(controller: FleetController,
                queries: Sequence,
                arrivals_s: Sequence[float],
                clk: Dict[str, float],
                events: Sequence[Tuple[float, Callable[[], None]]] = (),
                max_steps: int = 200_000,
                trace_every: int = 50) -> List[dict]:
    """Virtual-clock drive (the ``run_scenario`` discipline): arrivals
    enter at their timestamps, the clock advances by the fleet's modeled
    work per tick, idle gaps jump straight to the next arrival, scripted
    event, or heartbeat deadline — so fail-over detection costs zero wall
    time.  Returns the telemetry trajectory."""
    order = sorted(range(len(events)), key=lambda i: events[i][0])
    events = [events[i] for i in order]
    ev_i = arr_i = steps = 0
    last_modeled = controller.modeled_time_s()
    traj: List[dict] = []
    while arr_i < len(queries) or controller.unanswered:
        if steps >= max_steps:
            snaps = "\n".join(
                f"[shard {s.name}] " + s.server.drain_snapshot()
                for s in controller.live_shards())
            raise LivelockError(
                f"fleet not drained after {max_steps} steps "
                f"({len(controller.unanswered)} unanswered)\n{snaps}")
        while ev_i < len(events) and events[ev_i][0] <= clk["t"]:
            events[ev_i][1]()
            ev_i += 1
        live_pending = sum(s.load for s in controller.live_shards())
        if live_pending == 0:
            targets = []
            if arr_i < len(queries):
                targets.append(arrivals_s[arr_i])
            if ev_i < len(events):
                targets.append(events[ev_i][0])
            if controller.unanswered:
                deadline = controller.next_stale_deadline()
                if deadline is not None:
                    targets.append(deadline)
            ahead = [t for t in targets if t > clk["t"]]
            if ahead:
                # land on the next wake-up and fall through — the
                # admission loop below uses <=, so a jump exactly onto an
                # arrival admits it this very iteration (a `continue`
                # here would re-enter this block, see the target as
                # no-longer-ahead, and leapfrog it)
                clk["t"] = min(ahead)
                while ev_i < len(events) and events[ev_i][0] <= clk["t"]:
                    events[ev_i][1]()
                    ev_i += 1
        while arr_i < len(queries) and arrivals_s[arr_i] <= clk["t"]:
            controller.dispatch(queries[arr_i])
            arr_i += 1
        controller.step()
        steps += 1
        now = controller.modeled_time_s()
        clk["t"] += max(now - last_modeled, 1e-7)
        last_modeled = now
        if trace_every and steps % trace_every == 0:
            traj.append(controller.sample(clk["t"]))
    traj.append(controller.sample(clk["t"]))
    return traj
