"""Port parity of the replica fleet (``repro_torch.dist.elastic`` /
``repro_torch.dist.fleet``) against ``repro.dist``, on the CPU: every
replica on the one device, as the reference's tests run theirs on
degenerate (1, 1) meshes sharing device 0.

Held to the reference exactly: ``plan_rescale`` field for field; fleets of
stream replicas under a VirtualClock with the seeded and scripted
``replica_loss`` schedules of tests/test_fleet.py — the recovery trace
(``resil_log``), the injected events, every request's status and
``status_counts``, and ok payloads bit for bit, which also equal a clean
single engine's.  Then the supervisor's own arcs (decommission, last-replica
protection, retry exhaustion through the rewind, both routing signals, the
rescale clock, the gauges), an LM replica lost mid-chunked admission (the
reference's scenario; tokens equal to a clean run's and to the
reference's), LM replicas sharing one packed weight set, and
``launch.serve --replicas 3 --device cpu``."""
import numpy as np
import pytest
import torch

from repro.dist import elastic as jelastic
from repro.dist import fleet as jfleet
from repro import resil as jresil
from repro.serve import stream as jstream
from repro_torch import resil as tresil
from repro_torch.dist import elastic as telastic
from repro_torch.dist import fleet as tfleet
from repro_torch.serve import stream as tstream

torch.set_num_threads(2)

_CFG = tstream.StreamConfig()


def _clip(frames=4, seed=0):
    return tstream.make_clip(frames, _CFG.frame, q=_CFG.q, seed=seed)


def _policy(R, **kw):
    for k in ("deadline_ms", "ttft_deadline_ms", "max_queue", "max_queue_age_ms"):
        kw.setdefault(k, None)
    kw.setdefault("backoff_ms", 0.0)
    return R.ServePolicy(**kw)


def _plan(R, kind, arg):
    """A fleet fault plan of package ``R``: "seeded" (rate, seed) draws or
    "scripted" [(tick, replica)] kills."""
    if kind == "seeded":
        rate, seed = arg
        return R.FaultPlan(R.FaultSpec(replica_loss=rate), seed=seed)
    return R.FaultPlan(events=[R.FaultEvent(tick=t, kind="replica_loss", slot=s,
                                            target="replica") for t, s in arg])


def _tfleet(replicas=3, *, slots=2, faults=None, policy=None, clock=None, rescale_ms=5.0,
            route_by="slots", guards=True):
    clock = clock if clock is not None else tresil.VirtualClock()
    policy = policy if policy is not None else _policy(tresil)

    def build(mesh, rid):
        assert mesh.device == torch.device("cpu") and mesh.shape == (1, 1)
        return tstream.StreamServeEngine(tstream.StreamAdapter(device="cpu"), slots=slots,
                                         clock=clock, policy=policy,
                                         guards=tresil.GuardConfig() if guards else None)

    return tfleet.FleetSupervisor(build, replicas, clock=clock, faults=faults, policy=policy,
                                  rescale_ms=rescale_ms, route_by=route_by, device="cpu")


def _jfleet(replicas=3, *, slots=2, faults=None, policy=None, rescale_ms=5.0):
    clock = jresil.VirtualClock()
    policy = policy if policy is not None else _policy(jresil)

    def build(mesh, rid):
        return jstream.StreamServeEngine(slots=slots, clock=clock, policy=policy,
                                         guards=jresil.GuardConfig())

    return jfleet.FleetSupervisor(build, replicas, tp=1, clock=clock, faults=faults,
                                  policy=policy, rescale_ms=rescale_ms)


def _key(req):
    return tuple(np.asarray(f).tobytes() for f in req.out)


def _clean(clips, slots=2):
    eng = tstream.StreamServeEngine(tstream.StreamAdapter(device="cpu"), slots=slots)
    reqs = [eng.submit(c) for c in clips]
    eng.run_until_drained()
    assert all(r.status == "ok" for r in reqs)
    return {r.rid: _key(r) for r in reqs}


def _run(sup, clips, max_ticks=1200):
    reqs = [sup.submit(c) for c in clips]
    done = sup.run_until_drained(max_ticks=max_ticks)
    return reqs, done


# ---------------------------------------------------------------------------
# elastic planning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("per_pod", [8, 256])
def test_plan_rescale_matches_reference(tp, per_pod):
    """Every survivor count 1..40 (and whole pods past it) at three batch
    targets: the port's plan equals the reference's field for field."""
    for devices in list(range(1, 41)) + [255, 256, 257, 511, 512, 768]:
        for tgb in (1, 64, 256):
            j = jelastic.plan_rescale(devices, target_global_batch=tgb, tp=tp,
                                      devices_per_pod=per_pod)
            t = telastic.plan_rescale(devices, target_global_batch=tgb, tp=tp,
                                      devices_per_pod=per_pod)
            assert t.__dict__ == j.__dict__
            assert t.pods * t.data * t.model + t.idle_devices == devices
    for R in (jelastic, telastic):
        with pytest.raises(ValueError, match="no surviving devices"):
            R.plan_rescale(0, target_global_batch=8, tp=1)


# ---------------------------------------------------------------------------
# stream fleets against the reference
# ---------------------------------------------------------------------------


SCHEDULES = [("seeded", (0.2, 1)), ("seeded", (0.2, 5)), ("seeded", (0.2, 9)),
             ("seeded", (0.25, 17)), ("scripted", [(2, 1)]), ("scripted", [(3, 0)]),
             ("scripted", [(0, 0), (1, 1), (2, 2)]), ("scripted", [(1, 2), (4, 1)])]


@pytest.mark.parametrize("kind,arg", SCHEDULES,
                         ids=[f"{k}-{a}" for k, a in SCHEDULES])
def test_stream_fleet_matches_reference(kind, arg):
    """Ten clips on three stream replicas of two slots: the recovery trace,
    the injected events, each request's status and ``status_counts`` equal
    the reference's; every request ends once; ok payloads equal the
    reference's and a clean single engine's bit for bit."""
    clips = [_clip(5, seed=100 + i) for i in range(10)]
    jplan, tplan = _plan(jresil, kind, arg), _plan(tresil, kind, arg)
    js, ts = _jfleet(faults=jplan), _tfleet(faults=tplan)
    jreqs, jdone = _run(js, clips)
    treqs, tdone = _run(ts, clips)
    assert ts.resil_log == js.resil_log
    assert [(e.tick, e.kind, e.slot) for e in tplan.injected] == \
        [(e.tick, e.kind, e.slot) for e in jplan.injected]
    assert ts.status_counts() == js.status_counts()
    assert sorted(r.rid for r in tdone) == sorted(r.rid for r in treqs) == list(range(10))
    jby = {r.rid: (r.status, r.retries, _key(r)) for r in jdone}
    tby = {r.rid: (r.status, r.retries, _key(r)) for r in tdone}
    assert tby == jby
    ref = _clean(clips)
    assert all(_key(r) == ref[r.rid] for r in tdone if r.status == "ok")
    assert [r.alive for r in ts.replicas] == [r.alive for r in js.replicas]
    assert [r.died_at for r in ts.replicas] == [r.died_at for r in js.replicas]
    assert [p.__dict__ for p in ts.rescales] == [p.__dict__ for p in js.rescales]


def test_replica_loss_draws_match_reference():
    """The fleet-level draws (seeded, bound to the replica count) equal the
    reference's tick for tick; unbound plans draw no victim."""
    for seed in (3, 11):
        j = jresil.FaultPlan(jresil.FaultSpec(replica_loss=0.3), seed=seed).bind_fleet(4)
        t = tresil.FaultPlan(tresil.FaultSpec(replica_loss=0.3), seed=seed).bind_fleet(4)
        for tick in range(64):
            assert [(e.kind, e.slot) for e in t.events_at(tick)] == \
                [(e.kind, e.slot) for e in j.events_at(tick)]
    unbound = tresil.FaultPlan(tresil.FaultSpec(replica_loss=1.0), seed=3)
    assert not any(unbound.events_at(t) for t in range(5))
    assert tresil.FaultSpec.parse("replica=0.25").replica_loss == 0.25


def test_single_engine_ignores_replica_loss():
    """An engine's own plan records a ``replica_loss`` draw and does
    nothing with it (only a supervisor consumes the kind)."""
    plan = tresil.FaultPlan(events=[tresil.FaultEvent(tick=1, kind="replica_loss", slot=0,
                                                      target="replica")])
    eng = tstream.StreamServeEngine(tstream.StreamAdapter(device="cpu"), slots=2,
                                    faults=plan, clock=tresil.VirtualClock())
    reqs = [eng.submit(_clip(4, seed=i)) for i in range(3)]
    eng.run_until_drained()
    assert all(r.status == "ok" for r in reqs)
    assert [e.kind for e in plan.injected] == ["replica_loss"]
    ref = _clean([_clip(4, seed=i) for i in range(3)])
    assert all(_key(r) == ref[r.rid] for r in reqs)


# ---------------------------------------------------------------------------
# the supervisor's arcs
# ---------------------------------------------------------------------------


def test_routing_least_loaded_then_lowest_rid_and_unique_rids():
    sup = _tfleet(3)
    reqs = [sup.submit(_clip(seed=i)) for i in range(9)]
    for i, r in enumerate(reqs[:4]):
        assert r in sup.replicas[i % 3].engine.queue
    assert sorted(r.rid for r in reqs) == list(range(9))


def test_route_by_backlog_weighs_admission_work():
    """``backlog`` counts queued payload units: a replica holding one long
    clip stops looking as cheap as one holding a short clip; ``slots``
    counts requests and sends the third request back to replica 0."""
    for route_by, third in (("slots", 0), ("backlog", 1)):
        sup = _tfleet(2, route_by=route_by)
        sup.submit(_clip(40, seed=0))
        sup.submit(_clip(2, seed=1))
        r = sup.submit(_clip(2, seed=2))
        assert r in sup.replicas[third].engine.queue, route_by
    with pytest.raises(ValueError, match="route_by"):
        _tfleet(2, route_by="random")


def test_decommission_drains_with_zero_rewinds():
    sup = _tfleet(3)
    reqs = [sup.submit(_clip(5, seed=i)) for i in range(6)]
    for _ in range(2):
        sup.tick()
    plan = sup.decommission(1)
    assert plan is not None and not sup.replicas[1].alive
    done = sup.run_until_drained(max_ticks=800)
    assert len(done) == len(reqs) and all(r.status == "ok" for r in done)
    assert all(r.retries == 0 for r in done)
    names = [n for _, n, _ in sup.resil_log]
    assert "decommission" in names and "rewind" not in names
    assert sup.decommission(1) is None
    only = _tfleet(1)
    assert only.decommission(0) is None


def test_last_live_replica_is_never_killed():
    events = [(t, t) for t in range(3)]
    sup = _tfleet(3, faults=_plan(tresil, "scripted", events))
    reqs = [sup.submit(_clip(5, seed=i)) for i in range(6)]
    done = sup.run_until_drained(max_ticks=800)
    assert len(sup.live) == 1
    assert len(done) == len(reqs) and all(r.status == "ok" for r in done)
    assert any(n == "replica_loss_skipped" for _, n, _ in sup.resil_log)


def test_rewind_exhaustion_fails_exactly_once():
    sup = _tfleet(2, policy=_policy(tresil, max_retries=0),
                  faults=_plan(tresil, "scripted", [(2, 0)]))
    reqs = [sup.submit(_clip(6, seed=i)) for i in range(4)]
    done = sup.run_until_drained(max_ticks=800)
    assert sorted(r.rid for r in done) == sorted(r.rid for r in reqs)
    counts = sup.status_counts()
    assert counts.get("failed", 0) >= 1 and sum(counts.values()) == len(reqs)
    assert any(n == "request_failed" for _, n, _ in sup.resil_log)


def test_rescale_clock_gauges_and_counter():
    clock = tresil.VirtualClock()
    sup = _tfleet(3, clock=clock, faults=_plan(tresil, "scripted", [(1, 2)]), rescale_ms=40.0)
    [sup.submit(_clip(5, seed=i)) for i in range(6)]
    g = sup.registry.gauge("repro_replica_up", labels=("replica",))
    assert [g.labels(replica=str(r)).value for r in range(3)] == [1, 1, 1]
    t0 = clock()
    sup.run_until_drained(max_ticks=800)
    assert clock() - t0 == pytest.approx(0.040)
    hist = sup.registry.histogram("repro_rescale_seconds")
    assert hist.count == 1 and hist.sum == pytest.approx(0.040)
    assert [g.labels(replica=str(r)).value for r in range(3)] == [1, 1, 0]
    assert sup.registry.counter("repro_replica_loss_total").value == 1
    assert sup.rescales[-1].data == 2 and sup.rescales[-1].idle_devices == 0


def test_same_seed_gives_one_recovery_trace():
    def run():
        plan = _plan(tresil, "seeded", (0.25, 17))
        sup = _tfleet(3, faults=plan)
        _, done = _run(sup, [_clip(5, seed=i) for i in range(8)])
        return (tuple(sup.resil_log), tuple((e.tick, e.kind, e.slot) for e in plan.injected),
                tuple(sorted((r.rid, r.status, _key(r)) for r in done)))

    assert run() == run()


def test_fleet_devices_and_tensor_parallelism_refused(tmp_path):
    """``fleet_meshes``' slices and fallback, the reference's contract: in a
    world of one rank every replica is a (1, 1) mesh on the one device and
    a replica wider than the world raises; on four gloo ranks 3 replicas x
    tp=2 take ranks 0-1, 2-3 and (not fitting) 0-1 again, each rank a
    member of its slices only, with a model group there; 2 x 2 are
    disjoint; tp=8 raises on every rank."""
    import _torch_dp as H
    from repro_torch.dist import meshctx

    ms = tfleet.fleet_meshes(3, device="cpu")
    assert [(m.shape, m.device, m.member) for m in ms] == [((1, 1), torch.device("cpu"),
                                                            True)] * 3
    with pytest.raises(ValueError, match="tp=2 ranks does not fit a world of 1"):
        tfleet.fleet_meshes(2, tp=2, device="cpu")
    with pytest.raises(ValueError, match="at least one replica"):
        _tfleet(0)
    got = meshctx.spawn_ranks(H.meshes_rank, 4, store_dir=str(tmp_path), timeout_s=H.TIMEOUT_S,
                              args=([(3, 2), (2, 2), (1, 8)],))
    for rank, out in enumerate(got):
        slices = [(0, 1), (2, 3), (0, 1)]
        assert out[(3, 2)] == [(s, rank in s, s.index(rank) if rank in s else None,
                                rank in s) for s in slices]
        assert [m[0] for m in out[(2, 2)]] == slices[:2]
        assert "does not fit a world of 4" in out[(1, 8)]


# ---------------------------------------------------------------------------
# LM replicas
# ---------------------------------------------------------------------------


def test_lm_replica_lost_mid_chunked_admission_matches_reference():
    """The reference's scenario: a request mid-way through chunked prefill
    on replica 0 when it dies is rewound (cursor 0), requeued on replica 1,
    re-admitted from scratch and finishes with a clean run's tokens — and
    the reference's; the recovery traces are equal."""
    import jax

    import _torch_parity as P
    from repro.models import build_model as jbuild
    from repro.serve.admission import AdmissionConfig as JAdm
    from repro.serve.engine import ServeEngine as JServe
    from repro_torch.serve.admission import AdmissionConfig as TAdm
    from repro_torch.serve.lm import ServeEngine as TServe

    jm, jp, tm, tp = P.models("float32", "exact")
    prompt = np.random.default_rng(5).integers(1, jm.cfg.vocab, 40).astype(np.int32)
    out = {}
    for name, R, fleet, Serve, Adm, m, p in (
            ("jax", jresil, jfleet, JServe, JAdm, jm, jp),
            ("port", tresil, tfleet, TServe, TAdm, tm, tp)):
        adm = Adm(chunk_tokens=8, warmup=False)
        build = lambda dev, rid: Serve(m, p, slots=1, max_len=64, seed=7, admission=adm,
                                       emitter=False)
        kw = {"device": "cpu"} if name == "port" else {"tp": 1}
        sup = fleet.FleetSupervisor(build, 2, policy=_policy(R), rescale_ms=0.0, **kw)
        with P.jax_backend("pallas"):
            req = sup.submit(prompt, 3)
            eng0 = sup.replicas[0].engine
            eng0.tick()
            assert req in eng0.slot_req and 0 < req.cursor < req.payload_units - 1
            sup.kill(0)
            assert req.cursor == 0 and req in sup.replicas[1].engine.queue
            done = sup.run_until_drained()
        assert [r.rid for r in done] == [req.rid] and req.status == "ok"
        clean = build(None, 0)
        with P.jax_backend("pallas"):
            ref = clean.submit(prompt, 3)
            clean.run_until_drained()
        assert req.out == ref.out
        out[name] = (list(req.out), sup.resil_log)
    assert out["port"] == out["jax"]


def test_lm_replicas_share_one_packed_weight_set(capsys):
    """``launch.serve --replicas 3 --device cpu`` on the smoke arch under
    axq8 with seeded replica losses: every request ends once, ok; every
    replica serves the same packed tensors (no copy) with its own cache;
    greedy tokens equal a single engine's run of the same prompts; the
    fleet lines are printed.  ``--ring`` (a 1-wide model axis) and
    ``--mesh 2x1`` (a replica is a (1, M) mesh) raise; ``--tp 2`` serves
    sharded replicas (tests/test_torch_fleet_mesh.py)."""
    from repro_torch.kernels.qstore import PackedQWeight
    from repro_torch.launch import serve as launch_serve

    argv = ["--device", "cpu", "--approx", "axq8", "--requests", "8", "--new-tokens", "6",
            "--slots", "2"]
    s, sup = launch_serve.run(argv + ["--replicas", "3", "--faults", "replica_loss=0.3",
                                      "--fault-seed", "3", "--metrics"])
    assert s["requests"] == 8 and s["statuses"] == {"ok": 8} and s["rescales"] >= 1
    assert sorted(r.rid for r in sup.done) == list(range(8))
    p0 = sup.replicas[0].engine.params
    assert all(r.engine.params is p0 for r in sup.replicas)
    assert isinstance(p0["layers"]["wq"]["w"], PackedQWeight)
    caches = {id(r.engine.cache.k) for r in sup.replicas}
    assert len(caches) == 3
    _, eng = launch_serve.run(argv)
    single = {r.rid: r.out_tokens for r in eng.done}
    assert {r.rid: r.out_tokens for r in sup.done} == single
    text = capsys.readouterr().out
    assert "fleet: 8 reqs on 3 replica(s)" in text and "fleet events:" in text
    # a parameter storm flips weights in place: each replica gets its own copy
    _, storm = launch_serve.run(argv + ["--replicas", "3", "--faults",
                                        "replica_loss=0.3,seu_param=0.3", "--fault-seed", "3"])
    leaves = [r.engine.params["layers"]["wq"]["w"].qw for r in storm.replicas]
    assert len({t.data_ptr() for t in leaves}) == 3
    assert sorted(r.rid for r in storm.done) == list(range(8))
    for bad in (["--ring"], ["--mesh", "2x1"]):
        with pytest.raises(SystemExit):
            launch_serve.run(argv + ["--replicas", "3"] + bad)


def test_launch_serve_stream_fleet_with_engine_storms():
    """``--workload stream --replicas 3`` with engine kinds beside
    ``replica_loss``: the engine kinds become one plan a replica (seeded
    ``--fault-seed + rid``, ``replica_loss`` zeroed), the fleet draws the
    losses; every clip ends once."""
    from repro_torch.launch import serve as launch_serve

    s, sup = launch_serve.run(["--workload", "stream", "--device", "cpu", "--replicas", "3",
                               "--requests", "6", "--frames", "4", "--qos",
                               "--faults", "replica_loss=0.2,nan=0.2", "--fault-seed", "3"])
    assert sum(s["statuses"].values()) == 6 and sorted(r.rid for r in sup.done) == list(range(6))
    plans = [r.engine.faults for r in sup.replicas]
    assert all(p is not None and p.spec.replica_loss == 0 and p.seed == 3 + i
               for i, p in enumerate(plans))
    assert sup.faults.spec.replica_loss == 0.2
