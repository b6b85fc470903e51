"""Rank functions of the serving data-axis and sharded-fleet tests
(``tests/test_torch_dp_serve.py``, ``tests/test_torch_fleet_mesh.py``).

They run in processes that ``repro_torch.dist.meshctx.spawn_ranks`` starts
(gloo on the CPU, one thread a rank), so they live in a module that
imports no JAX: each rank gets numpy parameter trees built by the JAX
reference in the test process, and returns plain Python results.  Rank 0
also serves every job on the port's one-process engine (a trivial mesh in
its own process) for the comparison.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

from _torch_tp import engine_opts, policy_for
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.dist import collectives, meshctx
from repro_torch.models import build_model
from repro_torch.serve.admission import AdmissionConfig
from repro_torch.serve.lm import ServeEngine
from repro_torch.serve.sharded import ShardedServeEngine

TIMEOUT_S = 120.0
SLOTS = 4


@contextlib.contextmanager
def kv_int8(on: bool):
    """``REPRO_KV_INT8`` set while the engines are built (the cache and
    the chunk switch read it then)."""
    prev = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("REPRO_KV_INT8", None)
        else:
            os.environ["REPRO_KV_INT8"] = prev


def _job_kw(job: dict) -> dict:
    """The engine keywords of a job: admission, sampling, faults, clock."""
    from repro_torch.resil import (FaultPlan, FaultSpec, GuardConfig, ServePolicy,
                                   VirtualClock)

    kw = engine_opts(job)
    if job.get("adm"):
        kw["admission"] = AdmissionConfig(**job["adm"])
    if job.get("sample"):
        kw.update(greedy=False, temperature=0.8, top_k=8, seed=job["sample"])
    if job.get("faults"):
        kw.update(faults=FaultPlan(FaultSpec.parse(job["faults"]), seed=job["fault_seed"]),
                  guards=GuardConfig(),
                  policy=ServePolicy(deadline_ms=None, ttft_deadline_ms=None, max_queue=None,
                                     max_queue_age_ms=None, backoff_ms=0.0, max_retries=4),
                  clock=VirtualClock())
    if job.get("tap"):
        kw["quality_every"] = job["tap"]
    return kw


def _serve(eng, prompts, n_new) -> dict:
    reqs = [eng.submit(p, n_new) for p in prompts]
    eng.run_until_drained()
    out = {"streams": [list(r.out) for r in reqs], "status": [r.status for r in reqs],
           "degrees": [e for _, e in eng.stats.degree_history],
           "resil_log": list(eng.resil_log),
           "injected": [(e.tick, e.kind, e.slot) for e in (eng.faults.injected
                                                          if eng.faults else [])],
           "calls": dict(eng.workload.trace_counts)}
    if eng._tap is not None:
        out["tap"] = {k: (c.count, c.sum) for k, c in eng._tap.hist._children.items()}
    return out


def _cache(eng) -> dict:
    return {k: getattr(eng.cache, k).float().numpy() for k in eng.cache._fields}


def serve_jobs_rank(rank, world, shape, jobs):
    """Each job of ``jobs`` on one rank of a ``shape`` (data, model)
    engine of ``SLOTS`` slots over ``job["tree"]`` (the arch in f32):
    its streams, statuses, degree walk, recovery trace, call shapes, this
    rank's cache after the drain (``job["cache"]``) and, with
    ``job["tick"]``, one steady tick's collectives.  Rank 0 adds the same
    job on the port's one-process engine (``single``, its whole cache with
    ``job["cache"]``)."""
    mesh = meshctx.set_mesh(meshctx.make_mesh(tuple(shape), ("data", "model")))
    D, M = shape
    out = []
    for job in jobs:
        cfg = dataclasses.replace(get_config(job["arch"]), dtype="float32")
        model = build_model(cfg, policy_for(job.get("policy", "exact")), device="cpu")
        res = {"coord": {a: mesh.coord(a) for a in mesh.axis_names}}
        with kv_int8(job.get("int8", False)):
            eng = ShardedServeEngine(model, params_from_numpy(job["tree"]), mesh=mesh,
                                     slots=SLOTS, max_len=32, ring=job.get("ring", False),
                                     **_job_kw(job))
            res.update(_serve(eng, job["prompts"], job["new"]))
            res["cache_type"] = type(eng.cache).__name__
            res["rows"] = int(eng.cache.length.shape[0])
            if job.get("cache"):
                res["cache"] = _cache(eng)
            if job.get("tick"):
                for s in range(SLOTS):
                    eng.submit([1 + s, 2 + s, 3], 4)
                eng.tick()
                collectives.counter.reset()
                eng.tick()
                res["tick"] = collectives.counter.snapshot()
            if rank == 0 and job.get("single", True):
                with meshctx.use_mesh(meshctx.make_mesh((1, 1), ("data", "model"))):
                    ref = ServeEngine(model, params_from_numpy(job["tree"]), slots=SLOTS,
                                      max_len=32, tp=M, **_job_kw(job))
                    res["single"] = _serve(ref, job["prompts"], job["new"])
                    if job.get("cache"):
                        res["single"]["cache"] = _cache(ref)
        out.append(res)
    return out


def moe_refusal_rank(rank, world, shape, arch):
    """The MoE family on a data axis raises; returns the message."""
    mesh = meshctx.set_mesh(meshctx.make_mesh(tuple(shape), ("data", "model")))
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = build_model(cfg, device="cpu")
    try:
        ShardedServeEngine(model, model.init(seed=0, tp=shape[1]), mesh=mesh, slots=SLOTS,
                           max_len=32)
    except NotImplementedError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# the sharded fleet
# ---------------------------------------------------------------------------


def meshes_rank(rank, world, cases):
    """``fleet_meshes(replicas, tp)`` for each case on this rank: each
    mesh's ranks, membership and (for a member) coordinate; a replica wider
    than the world raises."""
    from repro_torch.dist.fleet import fleet_meshes

    out = {}
    for replicas, tp in cases:
        try:
            ms = fleet_meshes(replicas, tp, device="cpu")
        except ValueError as e:
            out[(replicas, tp)] = str(e)
            continue
        out[(replicas, tp)] = [(m.ranks, m.member, m.coord("model") if m.member else None,
                                m.group("model") is not None) for m in ms]
    return out


def _fleet(model, tree, tp, replicas, plan, *, slots=2):
    from repro_torch.dist.fleet import FleetSupervisor
    from repro_torch.resil import ServePolicy, VirtualClock

    clock = VirtualClock()
    policy = ServePolicy(deadline_ms=None, ttft_deadline_ms=None, max_queue=None,
                         max_queue_age_ms=None, backoff_ms=0.0)

    def build(mesh, rid):
        return ShardedServeEngine(model, params_from_numpy(tree), mesh=mesh, slots=slots,
                                  max_len=32, clock=clock, policy=policy)

    return FleetSupervisor(build, replicas, tp=tp, clock=clock, faults=plan, policy=policy,
                           device="cpu")


def fleet_rank(rank, world, arch, tree, tp, prompts, n_new, seeded):
    """The reference's scenario on this rank: 3 replicas x ``tp`` over
    the world (``fleet_meshes``' slices and fallback), replica 1 lost at
    tick 2 (a scripted plan), on a VirtualClock; then the seeded plan
    ``seeded`` = (rate, seed) twice.  Each run: the recovery trace, every
    request's (status, tokens), the last rescale plan, the replicas' up
    states, and which replicas this rank computes.  Rank 0 adds a clean
    one-process engine's tokens."""
    from repro_torch.resil import FaultEvent, FaultPlan, FaultSpec

    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = build_model(cfg, device="cpu")
    plans = {"scripted": lambda: FaultPlan(events=[FaultEvent(tick=2, kind="replica_loss",
                                                               slot=1, target="replica")]),
             "seeded": lambda: FaultPlan(FaultSpec(replica_loss=seeded[0]), seed=seeded[1])}
    out = {}
    for name in ("scripted", "seeded", "seeded_again"):
        plan = plans[name.split("_")[0]]()
        sup = _fleet(model, tree, tp, 3, plan)
        reqs = [sup.submit(p, n_new) for p in prompts]
        done = sup.run_until_drained(max_ticks=400)
        out[name] = {
            "resil_log": list(sup.resil_log),
            "done": sorted((r.rid, r.status, tuple(r.out)) for r in done),
            "rids": sorted(r.rid for r in done), "submitted": [r.rid for r in reqs],
            "rescale": dict(sup.rescales[-1].__dict__) if sup.rescales else None,
            "alive": [r.alive for r in sup.replicas],
            "members": [r.mesh.member for r in sup.replicas],
            "ranks": [r.mesh.ranks for r in sup.replicas]}
    if rank == 0:
        with meshctx.use_mesh(meshctx.make_mesh((1, 1), ("data", "model"))):
            ref = ServeEngine(model, params_from_numpy(tree), slots=2, max_len=32, tp=tp)
            rr = [ref.submit(p, n_new) for p in prompts]
            ref.run_until_drained()
        out["clean"] = {r.rid: tuple(r.out) for r in rr}
    return out
