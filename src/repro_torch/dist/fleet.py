"""Replica fleet supervision: serve through replica loss (the port of
``repro.dist.fleet``).

:class:`FleetSupervisor` fronts N data-parallel replica engines and owns
what a single engine cannot survive: a whole replica dying mid-decode.

The failure arc:

  1. a fleet-level :class:`~repro_torch.resil.FaultPlan` draws seeded
     ``replica_loss`` events (stateless per-tick draws, or a scripted
     list), bound to the replica count by ``bind_fleet``;
  2. the supervisor marks the victim dead (``repro_replica_up`` to 0),
     migrates its queued requests to survivors in order, and rewinds its
     in-flight requests the way the per-slot quarantine does — full
     rewind, capped backoff, ``failed`` past ``max_retries`` — so each
     request ends exactly once fleet-wide with a status in {ok, failed,
     shed, deadline};
  3. :func:`repro_torch.dist.elastic.plan_rescale` plans the survivor mesh
     (ragged counts park their surplus as ``idle_devices``), and the
     modeled rescale time is charged to the injectable clock
     (:class:`~repro_torch.resil.VirtualClock`) and observed into
     ``repro_rescale_seconds``;
  4. serving resumes on the survivors; each engine's own brownout ladder
     absorbs the capacity dip before anything sheds.

:meth:`FleetSupervisor.decommission` is the graceful twin: stop routing,
drain the slots in place, retire the replica — no rewinds.

Every transition goes to the fleet ``resil_log`` (``(tick, name,
sorted-args)`` tuples, equal across runs of one seed) and onto the
``fleet`` trace track.

Meshes (:func:`fleet_meshes`, the reference's): replica ``r`` is a
``(1, tp)`` mesh of world ranks ``[r tp, r tp + tp)`` when they exist,
else of the first ``tp`` ranks, so replicas may share ranks, as the
reference's share devices.  In a world of one rank every replica is a
``(1, 1)`` mesh on ``cuda:0`` (or the CPU when asked): LM replicas of one
model share one packed weight set — the caller's ``build_engine`` closes
over it — and each holds only its own cache, graphs and graph pool.

On several ranks the supervisor runs SPMD: every rank builds every
replica's engine (``build_engine(mesh, rid)``, the mesh's ``member`` False
where the rank lies outside it) and runs the same routing, kills,
rewinds, rescale plans and ``resil_log``.  A replica's device work runs
on its members only; each tick its first rank broadcasts the emission
(the packed tokens and ok bits, the tick's one read) over the world, and
every other rank's shadow of the engine advances the replica's host state
from it (``serve/sharded.py``).  The clock is world rank 0's, broadcast,
unless a deterministic one is passed.  At drain the ranks' streams are
all-gathered and must be equal.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.dist import meshctx
from repro_torch.dist.elastic import RescalePlan, plan_rescale
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import Registry


def fleet_meshes(replicas: int, tp: int = 1, device="cuda",
                 backend: Optional[str] = None) -> list:
    """One ``(1, tp)`` ``("data", "model")`` mesh a replica (the
    reference's contract): replica ``r`` on world ranks ``[r tp, r tp +
    tp)`` when they exist, else on the first ``tp`` ranks (replicas then
    share ranks).  Every rank must call it (each mesh's groups are made
    collectively); a rank outside a replica's ranks gets its mesh with
    ``member`` False.  A replica wider than the world raises."""
    if replicas < 1:
        raise ValueError("a fleet needs at least one replica")
    world = meshctx.world_size()
    if tp < 1 or tp > world:
        raise ValueError(f"a replica of tp={tp} ranks does not fit a world of {world} "
                         "rank(s) (spawn replicas x tp ranks: launch.serve --replicas N "
                         "--tp M)")
    dev = resolve_device(device)
    meshes = []
    for r in range(replicas):
        lo = r * tp
        ranks = range(lo, lo + tp) if lo + tp <= world else range(tp)
        meshes.append(meshctx.make_mesh((1, tp), ("data", "model"), device=dev,
                                        backend=backend, ranks=ranks))
    return meshes


@dataclass
class Replica:
    """One replica: its mesh slice, its engine, and liveness."""

    rid: int
    mesh: meshctx.Mesh
    engine: object
    alive: bool = True
    #: fleet tick the replica died on (None while alive)
    died_at: Optional[int] = None

    @property
    def device(self) -> torch.device:
        return self.mesh.device


class FleetSupervisor:
    """Route requests across replica engines and survive losing one.

    ``build_engine(mesh, rid)`` constructs one replica's engine on its
    mesh (:func:`fleet_meshes`; ``mesh.device`` its device); the caller
    closes over the shared pieces (model, params, engine fault plans, the
    clock).  Engine-level fault plans must not carry
    ``replica_loss`` (a single engine ignores the kind; ``launch.serve``
    zeroes it there): the fleet-level ``faults`` plan is where replica
    deaths are drawn.  ``policy`` governs the fleet-level rewind (retry
    cap and backoff of requests torn out of a dead replica's slots).
    ``rescale_ms`` is the modeled re-shard latency, charged to the clock."""

    def __init__(self, build_engine: Callable, replicas: int, *,
                 tp: int = 1, clock=None, faults=None, policy=None,
                 registry: Optional[Registry] = None, tracer=None,
                 rescale_ms: float = 5.0,
                 target_global_batch: Optional[int] = None,
                 route_by: str = "slots", device="cuda", backend: Optional[str] = None):
        if replicas < 1:
            raise ValueError("a fleet needs at least one replica")
        if route_by not in ("slots", "backlog"):
            raise ValueError("route_by must be 'slots' or 'backlog'")
        self.route_by = route_by
        self.tp = int(tp)
        meshes = fleet_meshes(replicas, self.tp, device, backend)
        if clock is None and meshctx.world_size() > 1:
            from repro_torch.serve.sharded import SharedClock

            clock = SharedClock(meshes[0])
        self._clock = clock if clock is not None else time.time
        self._tracer = tracer if tracer is not None else obs_trace.get_tracer()
        self.faults = faults
        if faults is not None:
            faults.bind_fleet(replicas)
        if policy is None:
            from repro_torch.resil import ServePolicy
            policy = ServePolicy()
        self.policy = policy
        self.rescale_ms = float(rescale_ms)
        self.registry = registry if registry is not None else Registry()
        self._g_up = self.registry.gauge(
            "repro_replica_up", "replica liveness (1 = serving)", labels=("replica",))
        self._h_rescale = self.registry.histogram(
            "repro_rescale_seconds", "elastic rescale duration")
        self._c_loss = self.registry.counter(
            "repro_replica_loss_total", "replica-loss events applied")
        self.replicas: list[Replica] = []
        # one fleet-wide request-id counter: per-engine counters would
        # collide across replicas and leave the recovery trace ambiguous
        shared_rid = itertools.count()
        for rid, mesh in enumerate(meshes):
            eng = build_engine(mesh, rid)
            eng._rid = shared_rid
            self.replicas.append(Replica(rid, mesh, eng))
            self._g_up.labels(replica=str(rid)).set(1)
        # the fleet's batch target for rescale planning: its slots
        self._tgb = (int(target_global_batch) if target_global_batch
                     else sum(r.engine.slots for r in self.replicas))
        self._ticks = 0
        #: the fleet's recovery trace, in the engines' tuple format
        self.resil_log: list = []
        #: requests terminated at fleet level (rewind past the retry cap)
        self._fleet_done: list = []
        #: the survivor-mesh plans, one per rescale, newest last
        self.rescales: list[RescalePlan] = []

    # -- liveness ---------------------------------------------------------

    @property
    def live(self) -> list[Replica]:
        return [r for r in self.replicas if r.alive]

    def _event(self, name: str, **args) -> None:
        self.resil_log.append((self._ticks, name, tuple(sorted(args.items()))))
        self._tracer.event(name, track="fleet", tick=self._ticks, **args)

    # -- routing ----------------------------------------------------------

    def _route(self) -> Replica:
        """Least-loaded live replica, ties to the lowest rid.  ``slots``
        counts requests (queued and in a slot); ``backlog`` counts
        admission work: queued payload units plus the un-ingested rest of
        every slot still mid-admission."""
        live = self.live
        if not live:
            raise RuntimeError("no live replicas")

        def load(r: Replica) -> tuple:
            eng = r.engine
            busy = sum(1 for q in eng.slot_req if q is not None)
            if self.route_by == "backlog":
                wl = eng.workload
                units = sum(q.payload_units for q in eng.queue)
                units += sum(max(q.payload_units - 1 - q.cursor, 0)
                             for q in eng.slot_req
                             if q is not None and not wl.admit_complete(q))
                return (units + busy, r.rid)
            return (len(eng.queue) + busy, r.rid)

        return min(live, key=load)

    def submit(self, payload, budget=None, **kw):
        """Enqueue one request on the least-loaded live replica; returns
        the live Request."""
        return self._route().engine.submit(payload, budget, **kw)

    # -- failure path -----------------------------------------------------

    def _finish_fleet(self, req, status: str, now: float) -> None:
        req.status = status
        req.done = True
        req.t_done = now
        self._fleet_done.append(req)

    def _rewind(self, req, now: float) -> None:
        """Tear one in-flight request out of a dead replica: the full
        rewind of the per-slot quarantine, front-requeued onto a survivor
        behind capped backoff, or failed past the retry cap."""
        req.retries += 1
        if req.retries > self.policy.max_retries:
            self._finish_fleet(req, "failed", now)
            self._event("request_failed", rid=req.rid, retries=req.retries)
            return
        req.out.clear()
        req.cursor = 0
        req.admitted_units = 0
        req.t_first_emit = 0.0
        req.degree_at_first_emit = None
        backoff = self.policy.backoff_s(req.retries)
        req.eligible_at = now + backoff
        target = self._route()
        target.engine.queue.appendleft(req)
        self._event("rewind", rid=req.rid, retries=req.retries,
                    to_replica=target.rid, backoff_ms=round(backoff * 1e3, 3))

    def _migrate_queue(self, victim: Replica) -> int:
        """Move a dead or draining replica's queued (never admitted)
        requests to survivors, in FIFO order."""
        moved = 0
        while victim.engine.queue:
            req = victim.engine.queue.popleft()
            target = self._route()
            target.engine.queue.append(req)
            moved += 1
            self._event("migrate", rid=req.rid, to_replica=target.rid)
        return moved

    def _rescale(self, reason: str) -> RescalePlan:
        """Plan the survivor mesh and charge the re-shard latency to the
        clock (advanced when injectable, else slept)."""
        survivors = len(self.live)
        plan = plan_rescale(max(survivors, 1) * self.tp,
                            target_global_batch=self._tgb, tp=self.tp)
        seconds = self.rescale_ms / 1e3
        advance = getattr(self._clock, "advance", None)
        if advance is not None:
            advance(seconds)
        else:
            time.sleep(seconds)
        self._h_rescale.observe(seconds)
        self.rescales.append(plan)
        self._event("rescale", reason=reason, replicas=survivors, data=plan.data,
                    model=plan.model, idle=plan.idle_devices,
                    ms=round(seconds * 1e3, 3))
        return plan

    def _retire(self, victim: Replica) -> None:
        victim.alive = False
        victim.died_at = self._ticks
        self._g_up.labels(replica=str(victim.rid)).set(0)

    def kill(self, rid: int, reason: str = "fault") -> Optional[RescalePlan]:
        """Hard replica loss: mark dead, migrate its queue, rewind its
        in-flight slots onto survivors, replan.  The last live replica is
        never killed (the event is logged and skipped)."""
        victim = self.replicas[rid]
        if not victim.alive:
            return None
        if len(self.live) == 1:
            self._event("replica_loss_skipped", replica=rid, why="last_live_replica")
            return None
        self._retire(victim)
        self._c_loss.inc()
        now = self._clock()
        self._event("replica_lost", replica=rid, reason=reason)
        moved = self._migrate_queue(victim)
        eng = victim.engine
        rewound = 0
        for s in range(eng.slots):
            req = eng.slot_req[s]
            if req is None:
                continue
            eng.slot_req[s] = None
            self._rewind(req, now)
            rewound += 1
        self._event("replica_drained", replica=rid, migrated=moved, rewound=rewound)
        return self._rescale(f"replica_loss:{rid}")

    def decommission(self, rid: int, max_ticks: int = 1000) -> Optional[RescalePlan]:
        """Graceful retirement: migrate the replica's queue, let its slots
        drain in place, then retire it and replan — no rewinds."""
        victim = self.replicas[rid]
        if not victim.alive or len(self.live) == 1:
            return None
        self._event("decommission", replica=rid)
        self._migrate_queue(victim)
        ticks = 0
        while any(r is not None for r in victim.engine.slot_req) and ticks < max_ticks:
            victim.engine.tick()
            self._migrate_queue(victim)   # quarantine requeues drain too
            ticks += 1
        self._retire(victim)
        self._event("replica_drained", replica=rid, migrated=0, rewound=0)
        return self._rescale(f"decommission:{rid}")

    # -- the fleet loop ---------------------------------------------------

    def _apply_faults(self) -> None:
        for ev in self.faults.events_at(self._ticks):
            if ev.kind != "replica_loss":
                continue   # engine-level kinds belong to engine-level plans
            self.faults.record(ev)
            self.kill(ev.slot % len(self.replicas), reason="injected")

    def tick(self) -> int:
        """One fleet iteration: this tick's replica losses, then one tick
        of every live engine.  Returns the active slots fleet-wide."""
        if self.faults is not None:
            self._apply_faults()
        active = 0
        for r in self.live:
            active += r.engine.tick()
        self._ticks += 1
        return active

    def run_until_drained(self, max_ticks: int = 10_000) -> list:
        """Tick until every live queue and slot is empty (or ``max_ticks``);
        returns the fleet-wide done list."""
        ticks = 0
        while any(r.engine.queue or any(q is not None for q in r.engine.slot_req)
                  for r in self.live) and ticks < max_ticks:
            self.tick()
            ticks += 1
        for r in self.live:
            if getattr(r.engine, "emitter", None) is not None:
                r.engine.emitter.flush()
        self.check_streams()
        return self.done

    def streams(self) -> list:
        """(rid, status, tokens) of every terminated request, by rid."""
        return [(q.rid, q.status, tuple(np.asarray(x).tobytes() for x in q.out))
                for q in sorted(self.done, key=lambda q: q.rid)]

    def check_streams(self) -> None:
        """On several ranks: all-gather every rank's streams over the world;
        raises unless they are equal."""
        if meshctx.world_size() > 1:
            from repro_torch.serve.sharded import check_equal_streams

            check_equal_streams(self.streams())

    # -- accounting -------------------------------------------------------

    @property
    def done(self) -> list:
        """Every terminated request fleet-wide, dead replicas' included,
        plus the requests the fleet failed out of the rewind path: one
        entry per submitted request."""
        out = []
        for r in self.replicas:
            out.extend(r.engine.done)
        out.extend(self._fleet_done)
        return out

    def status_counts(self) -> dict:
        """Fleet-wide ``{ok, failed, shed, deadline}`` tally."""
        counts: dict = {}
        for req in self.done:
            counts[req.status] = counts.get(req.status, 0) + 1
        return counts
