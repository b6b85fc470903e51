"""Port parity of the resilience layer (``repro_torch.resil``, the
``cache_ops`` bit flips, ``dispatch.inject_fault`` and the engine's
quarantine / deadline / shedding / brownout / scrub wiring) against the JAX
reference in the same process — mirroring tests/test_resil.py, each check
held to what JAX's function gives on the same inputs.

Engine against engine: the JAX ``StreamServeEngine`` / ``ServeEngine`` and
the port's on the same (converted) weights, traffic, fault plan and
``VirtualClock`` must give the same recovery trace (``resil_log``), the
same injected faults, the same terminal statuses and the same output of
every ok request — the stream's frames bit for bit (integer pipeline), the
LM's greedy tokens (f32 smoke model; a token where the port's top-2 logit
margin is under 1e-2 is a near-tie of the two packages' f32 rounding,
tests/test_torch_serve.py, and ends that request's comparison), plus the
Prometheus text of the resilience families.  The card's side (the guarded
step captured, an in-place flip reaching the replay, a scrub restoring the
bytes) is in tests/test_torch_gpu.py."""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core.dynamic import QoSController as JQoS
from repro.kernels.dispatch import inject_fault as jinject
from repro.models.cache_ops import bit_flip as jbit_flip
from repro.models.cache_ops import cache_bit_flip as jcache_bit_flip
from repro.obs import metrics as jmetrics
from repro import resil as jresil
from repro.serve import stream as jstream
from repro.serve.admission import AdmissionConfig as JAdmission
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch import resil as tresil
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.kernels import qstore as tqstore
from repro_torch.kernels.dispatch import inject_fault as tinject
from repro_torch.models.cache_ops import bit_flip, cache_bit_flip
from repro_torch.obs.metrics import parse_text
from repro_torch.resil.faults import tree_leaves
from repro_torch.serve import stream as tstream
from repro_torch.serve.admission import AdmissionConfig as TAdmission
from repro_torch.serve.lm import ServeEngine as TServeEngine

torch.set_num_threads(2)

J = types.SimpleNamespace(
    resil=jresil, QoS=JQoS, Admission=JAdmission,
    stream_engine=lambda **kw: jstream.StreamServeEngine(jstream.StreamAdapter(), **kw),
    lm_engine=JServeEngine)
T = types.SimpleNamespace(
    resil=tresil, QoS=TQoS, Admission=TAdmission,
    stream_engine=lambda **kw: tstream.StreamServeEngine(
        tstream.StreamAdapter(device="cpu"), **kw),
    lm_engine=TServeEngine)

_CFG = tstream.StreamConfig()

#: every bit of each dtype a flip is held at (torch dtype, jnp dtype, bits)
FLIP_DTYPES = [(torch.float32, jnp.float32, 32), (torch.bfloat16, jnp.bfloat16, 16),
               (torch.float16, jnp.float16, 16), (torch.int32, jnp.int32, 32),
               (torch.int8, jnp.int8, 8)]

#: the resilience families, whose Prometheus text must equal the reference's
RESIL_FAMILIES = ("repro_faults_injected_total", "repro_guard_trips_total",
                  "repro_retries_total", "repro_requests_failed_total",
                  "repro_requests_shed_total", "repro_deadline_miss_total",
                  "repro_brownout_total", "repro_param_scrubs_total",
                  "repro_dropped_ticks_total")


def _clip(frames=4, seed=0):
    return jstream.make_clip(frames, _CFG.frame, q=_CFG.q, seed=seed)


def _bits(a) -> np.ndarray:
    """The raw bits of an array or tensor, as unsigned integers."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        a = a.numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("text", [
    "seu=0.1,param=0.05,inf=0.2,latency=0.01,drop=0.02",
    "nan=0.5,spike_ms=9,seu_bit=uniform",
    "seu_state=0.02,seu_param=0.01,nan=0.05,spike=0.02,drop=0.02,replica_loss=0.1",
    "state=0.3,seu_bit=5,inf_ratio=0.25"])
def test_faultspec_parse_matches_reference(text):
    t = tresil.FaultSpec.parse(text)
    j = jresil.FaultSpec.parse(text)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


@pytest.mark.parametrize("text", ["gamma_ray=0.5", "nan"])
def test_faultspec_parse_errors(text):
    with pytest.raises(ValueError):
        jresil.FaultSpec.parse(text)
    with pytest.raises(ValueError):
        tresil.FaultSpec.parse(text)


@pytest.mark.parametrize("tdt,jdt,nbits", FLIP_DTYPES, ids=[str(d[1].__name__) for d in FLIP_DTYPES])
def test_bit_flip_every_bit_matches_reference(tdt, jdt, nbits):
    """Every bit, sign bits included: the port's in-place flip gives JAX's
    bits, changes exactly one element, and a second flip restores it."""
    rng = np.random.default_rng(nbits)
    base = rng.integers(-40, 40, (3, 5)).astype(np.float32)
    ja = jnp.asarray(base, jdt)
    for bit in range(nbits):
        idx = (bit * 7) % 15
        t = (torch.from_numpy(np.array(ja.astype(jnp.float32))).to(tdt)
             if tdt.is_floating_point else torch.from_numpy(np.array(ja)))
        before = _bits(t).copy()
        out = bit_flip(t, idx, bit)
        assert out is t                                   # in place
        np.testing.assert_array_equal(_bits(t), _bits(jbit_flip(ja, idx, bit)))
        assert (_bits(t) != before).sum() == 1
        bit_flip(t, idx, bit)
        np.testing.assert_array_equal(_bits(t), before)


def test_bit_flip_follows_logical_order_on_strided_views():
    """A column-major EMUL pack and a cache slot's region flip at the
    element of the reference's row-major flat index."""
    rng = np.random.default_rng(0)
    a = rng.integers(-100, 100, (6, 8)).astype(np.int8)
    col = tqstore.emul_layout(torch.from_numpy(a.copy()))
    assert not col.is_contiguous()
    for idx, bit in ((0, 7), (13, 3), (47, 6)):
        bit_flip(col, idx, bit)
        np.testing.assert_array_equal(col.contiguous().numpy(),
                                      np.asarray(jbit_flip(jnp.asarray(a), idx, bit)))
        a = col.contiguous().numpy().copy()


@pytest.mark.parametrize("workload", ["stream", "lm"])
def test_cache_bit_flip_isolates_the_slot_and_refuses_length(workload):
    if workload == "stream":
        jstate = jstream.StreamAdapter().init_state(batch=3, max_len=0)
    else:
        jm, jp, tm, tp = P.models("float32", "axq8")
        jstate = jm.init_cache(tp=1, batch=3, max_len=16)
        jstate = jstate._replace(k=jnp.asarray(
            np.random.default_rng(1).standard_normal(jstate.k.shape), jstate.k.dtype))
    tstate = (tstream.StreamAdapter(device="cpu").init_state(batch=3, max_len=0)
              if workload == "stream" else P.port_cache(jstate))
    field = next(n for n in tstate._fields if n != "length")
    before = {n: _bits(getattr(tstate, n)).copy() for n in tstate._fields}
    out = cache_bit_flip(tstate, field, 1, 5, 14 if workload == "lm" else 30)
    assert out is tstate
    jout = jcache_bit_flip(jstate, field, 1, 5, 14 if workload == "lm" else 30)
    for name in tstate._fields:
        now = _bits(getattr(tstate, name))
        np.testing.assert_array_equal(now, _bits(getattr(jout, name)))
        if name == field:
            assert (now[:, 1] != before[name][:, 1]).sum() == 1
            np.testing.assert_array_equal(now[:, [0, 2]], before[name][:, [0, 2]])
        else:
            np.testing.assert_array_equal(now, before[name])
    with pytest.raises(ValueError):
        cache_bit_flip(tstate, "length", 0, 0, 0)


def test_inject_fault_matches_reference():
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    assert tinject(torch.from_numpy(x), None) is not None
    t = torch.from_numpy(x)
    assert tinject(t, None) is t
    for f in ([0.0, 0.0, 0.0], [0.0, np.nan, 0.0], [np.inf, 0.0, -np.inf]):
        fa = np.asarray(f, np.float32)
        np.testing.assert_array_equal(
            tinject(torch.from_numpy(x), torch.from_numpy(fa)).numpy(),
            np.asarray(jinject(jnp.asarray(x), jnp.asarray(fa))))
        for dt in (np.int32, np.int8):
            xi = np.arange(6, dtype=dt).reshape(3, 2)
            np.testing.assert_array_equal(
                tinject(torch.from_numpy(xi), torch.from_numpy(fa)).numpy(),
                np.asarray(jinject(jnp.asarray(xi), jnp.asarray(fa))))


def test_slot_ok_matches_reference():
    x = np.asarray([[1.0, 2.0], [np.nan, 0.0], [np.inf, 0.0], [50.0, 0.0]], np.float32)
    xi = np.asarray([[5, 2], [2**30, 0]], np.int32)
    for a in (x, xi, x[:, 0], x.reshape(4, 1, 2)):
        for limit in (None, 10.0, 1e4):
            np.testing.assert_array_equal(
                tresil.slot_ok(torch.from_numpy(np.ascontiguousarray(a)), limit=limit).numpy(),
                np.asarray(jresil.slot_ok(jnp.asarray(a), limit=limit)))


def test_retry_helper_backoff_exhaustion_and_passthrough():
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 4:
            raise OSError("transient")
        return "ok"

    assert tresil.retry(flaky, attempts=5, backoff=0.05, cap=0.08,
                        sleep=sleeps.append) == "ok"
    assert calls["n"] == 4 and sleeps == [0.05, 0.08, 0.08]
    with pytest.raises(OSError):
        tresil.retry(lambda: (_ for _ in ()).throw(OSError("down")),
                     attempts=2, sleep=lambda s: None)
    with pytest.raises(KeyError):
        tresil.retry(lambda: {}["x"], attempts=5, sleep=lambda s: None)
    with pytest.raises(ValueError):
        tresil.retry(lambda: 1, attempts=0)


def test_quality_sentinel_matches_reference():
    seq = [5.0, 5.0, 5.0, 0.5, 5.0, 9.0, 9.0, 9.0, 0.1, 40.0]
    for mode, thr, window in (("max", 1.0, 2), ("min", 30.0, 1), ("max", 4.0, 3)):
        t = tresil.QualitySentinel(thr, mode=mode, window=window)
        j = jresil.QualitySentinel(thr, mode=mode, window=window)
        assert [t.observe(v) for v in seq] == [j.observe(v) for v in seq]
        assert t.trips == j.trips
    with pytest.raises(ValueError):
        tresil.QualitySentinel(1.0, mode="median")


def test_virtual_clock_and_policy_backoff():
    c = tresil.VirtualClock(5.0)
    assert c() == 5.0 and c.advance(0.25) == 5.25 and c() == 5.25
    tp, jp = tresil.ServePolicy(backoff_ms=3.0), jresil.ServePolicy(backoff_ms=3.0)
    assert [tp.backoff_s(r) for r in range(8)] == [jp.backoff_s(r) for r in range(8)]


# ---------------------------------------------------------------------------
# the fault schedule
# ---------------------------------------------------------------------------

SPECS = [dict(seu_state=0.4, seu_param=0.3, nan=0.4, spike=0.2, drop=0.2),
         dict(seu_state=0.3, seu_param=0.5, nan=0.1, seu_bit="uniform"),
         dict(seu_param=0.6, seu_bit=3, replica_loss=0.2)]


@pytest.mark.parametrize("spec", SPECS, ids=["biased", "uniform", "bit3"])
@pytest.mark.parametrize("workload", ["stream", "lm"])
def test_fault_plan_events_equal_reference(spec, workload):
    """Bound on the same state and parameters (the LM's converted from
    JAX's prepacked tinyllama-1.1b-smoke tree), the port draws JAX's events
    event for event: the leaf numbering follows JAX's flatten order."""
    if workload == "stream":
        jstate = jstream.StreamAdapter().init_state(batch=3, max_len=0)
        jparams = jstream.StreamAdapter().init_params()
        tad = tstream.StreamAdapter(device="cpu")
        tstate, tparams = tad.init_state(batch=3, max_len=0), tad.init_params()
    else:
        jm, jparams, tm, tparams = P.models("float32", "axq8")
        jstate = jm.init_cache(tp=1, batch=3, max_len=16)
        tstate = P.port_cache(jstate)
        jleaves = jax.tree_util.tree_leaves(jparams)
        tl = tree_leaves(tparams)
        assert [tuple(a.shape) for a in jleaves] == [tuple(b.shape) for b in tl]
        assert [np.asarray(a).dtype.itemsize for a in jleaves] == [b.element_size() for b in tl]
    for seed in (0, 3, 17):
        j = jresil.FaultPlan(jresil.FaultSpec(**spec), seed=seed).bind(jstate, jparams, 3)
        t = tresil.FaultPlan(tresil.FaultSpec(**spec), seed=seed).bind(tstate, tparams, 3)
        t.bind_fleet(4)
        j.bind_fleet(4)
        jev = [e.args() | {"tick": e.tick} for tick in range(60) for e in j.events_at(tick)]
        tev = [e.args() | {"tick": e.tick} for tick in range(60) for e in t.events_at(tick)]
        assert tev == jev and tev
    fwd = [t.events_at(k) for k in range(30)]
    assert fwd == [t.events_at(k) for k in reversed(range(30))][::-1]


def test_fault_plan_scripted_and_ctor_validation():
    ev = tresil.FaultEvent(tick=3, kind="drop")
    plan = tresil.FaultPlan(events=[ev])
    assert plan.events_at(3) == [ev] and plan.events_at(2) == []
    with pytest.raises(ValueError):
        tresil.FaultPlan()
    jev = jresil.FaultEvent(tick=3, kind="nan", slot=1, value=float("nan"))
    tev = tresil.FaultEvent(tick=3, kind="nan", slot=1, value=float("nan"))
    assert tev.args() == jev.args()


def test_apply_params_flips_in_place_at_the_reference_leaf():
    """The port flips the leaf JAX's ``apply_params`` flips, in place."""
    from repro_torch.convert import params_from_numpy

    jm, jparams, tm, _ = P.models("float32", "axq8")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams))   # a fresh copy
    for leaf, index, bit in ((0, 3, 30), (4, 17, 6), (len(tree_leaves(tparams)) - 1, 5, 13)):
        ev_t = tresil.FaultEvent(0, "seu_param", leaf=leaf, index=index, bit=bit)
        ev_j = jresil.FaultEvent(0, "seu_param", leaf=leaf, index=index, bit=bit)
        target = tree_leaves(tparams)[leaf]
        out = tresil.FaultPlan(events=[]).apply_params(tparams, ev_t)
        assert out is tparams and tree_leaves(out)[leaf] is target
        jparams = jresil.FaultPlan(events=[]).apply_params(jparams, ev_j)
        np.testing.assert_array_equal(_bits(target),
                                      _bits(jax.tree_util.tree_leaves(jparams)[leaf]))


# ---------------------------------------------------------------------------
# engine against engine
# ---------------------------------------------------------------------------


def _nan_plan(ns, ticks, slot=0):
    return ns.resil.FaultPlan(events=[ns.resil.FaultEvent(tick=t, kind="nan", slot=slot,
                                                           value=float("nan"))
                                      for t in ticks])


def _stream_scenario(ns, name):
    """(engine, requests, clock, seconds a tick) of one stream scenario,
    built from ``ns``'s package (the reference's tests/test_resil.py)."""
    R = ns.resil
    clock = R.VirtualClock()
    ladder = [{"degrees": [e] * 3} for e in (8, 6, 4)]
    if name == "quarantine":
        eng = ns.stream_engine(slots=1, faults=_nan_plan(ns, [1]))
        return eng, [eng.submit(_clip(4))], None, 0
    if name == "retry_exhaustion":
        eng = ns.stream_engine(slots=1, faults=_nan_plan(ns, range(200)),
                               policy=R.ServePolicy(max_retries=2, backoff_ms=0.01))
        return eng, [eng.submit(_clip(3))], None, 0
    if name == "deadline_edges":
        eng = ns.stream_engine(slots=1, clock=clock, guards=R.GuardConfig(),
                               policy=R.ServePolicy())
        reqs = [eng.submit(_clip(8)), eng.submit(_clip(2), deadline_ms=5.0),
                eng.submit(_clip(30), deadline_ms=40.0)]
        return eng, reqs, clock, 0.002
    if name == "ttft_dropped_ticks":
        drops = [R.FaultEvent(tick=t, kind="drop") for t in range(8)]
        eng = ns.stream_engine(slots=1, clock=clock, faults=R.FaultPlan(events=drops),
                               policy=R.ServePolicy())
        return eng, [eng.submit(_clip(2), ttft_deadline_ms=5.0)], clock, 0.002
    if name in ("brownout_before_shed", "shed_only"):
        brown = name == "brownout_before_shed"
        qos = ns.QoS(ladder=ladder, low_water=0.25, high_water=0.75,
                     cooldown_steps=3) if brown else None
        eng = ns.stream_engine(slots=1, qos=qos, clock=clock,
                               policy=R.ServePolicy(max_queue=1, brownout=brown),
                               guards=R.GuardConfig())
        return eng, [eng.submit(_clip(2, seed=i)) for i in range(6)], clock, 0.001
    if name == "queue_age":
        eng = ns.stream_engine(slots=1, clock=clock, guards=R.GuardConfig(),
                               policy=R.ServePolicy(max_queue_age_ms=4.0))
        return eng, [eng.submit(_clip(8)), eng.submit(_clip(2))], clock, 0.002
    if name == "storm":
        spec = R.FaultSpec(seu_state=0.25, seu_param=0.15, nan=0.25, drop=0.1, spike=0.1)
        eng = ns.stream_engine(slots=2, clock=clock, faults=R.FaultPlan(spec, seed=11),
                               policy=R.ServePolicy(deadline_ms=60.0, max_queue=3,
                                                    max_retries=2, backoff_ms=0.5))
        return eng, [eng.submit(_clip(3, seed=i)) for i in range(10)], clock, 0.002
    if name == "sentinel_scrub":
        ev = R.FaultEvent(tick=0, kind="seu_param", leaf=0, target="0", index=0, bit=30)
        eng = ns.stream_engine(
            slots=1, degree=[8, 8, 8], quality_every=1, faults=R.FaultPlan(events=[ev]),
            guards=R.GuardConfig(sentinel_threshold=200.0, sentinel_mode="min"))
        return eng, [eng.submit(_clip(3))], None, 0
    if name == "dropped_tick":
        eng = ns.stream_engine(slots=1, faults=R.FaultPlan(
            events=[R.FaultEvent(tick=1, kind="drop")]))
        return eng, [eng.submit(_clip(3))], None, 0
    if name == "spike":
        eng = ns.stream_engine(slots=1, clock=clock, faults=R.FaultPlan(
            events=[R.FaultEvent(tick=0, kind="spike", value=0.125)]))
        return eng, [eng.submit(_clip(2))], clock, 0
    raise KeyError(name)


def _drive(eng, reqs, clock, dt, max_ticks=500):
    for _ in range(max_ticks):
        if all(r.done for r in reqs):
            break
        eng.tick()
        if clock is not None and dt:
            clock.advance(dt)
    if eng.emitter is not None:
        eng.emitter.flush()
    return eng


def _outcome(eng, reqs) -> dict:
    return {"log": list(eng.resil_log),
            "injected": [e.args() | {"tick": e.tick}
                         for e in (eng.faults.injected if eng.faults else [])],
            "status": [r.status for r in reqs], "retries": [r.retries for r in reqs],
            "done": sorted(r.rid for r in eng.done),
            "steps": int(eng.stats.c_steps.value)}


def _resil_text(registry) -> list:
    return [ln for ln in registry.to_prometheus().splitlines()
            if any(f in ln for f in RESIL_FAMILIES)]


STREAM_SCENARIOS = ("quarantine", "retry_exhaustion", "deadline_edges", "ttft_dropped_ticks",
                    "brownout_before_shed", "shed_only", "queue_age", "storm",
                    "sentinel_scrub", "dropped_tick", "spike")


@pytest.mark.parametrize("name", STREAM_SCENARIOS)
def test_stream_engine_matches_reference(name):
    jeng, jreqs, jclock, dt = _stream_scenario(J, name)
    _drive(jeng, jreqs, jclock, dt)
    teng, treqs, tclock, _ = _stream_scenario(T, name)
    _drive(teng, treqs, tclock, dt)
    assert all(r.done for r in treqs)
    got, want = _outcome(teng, treqs), _outcome(jeng, jreqs)
    assert got == want
    for jr, tr in zip(jreqs, treqs):
        assert len(tr.out) == len(jr.out) <= tr.budget
        for a, b in zip(jr.out, tr.out):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
    # exactly once each, with a status of the partition
    assert len(teng.done) == len(treqs) == len({r.rid for r in teng.done})
    assert {r.status for r in treqs} <= {"ok", "failed", "shed", "deadline"}
    assert _resil_text(teng.stats.registry) == _resil_text(jeng.stats.registry)
    if tclock is not None:
        assert tclock() == jclock()
    if name == "sentinel_scrub":
        assert any(n == "param_scrub" for _, n, _ in teng.resil_log)
        assert teng.params_golden()
    if name == "brownout_before_shed":
        assert int(teng.stats.c_brownout.value) == 2 and teng.qos.degree == 2


def test_stream_storm_prometheus_equals_reference():
    """Under a storm the whole registry parses to the reference's samples
    (the route counters aside: their backend label names the package's
    own backend), and the resilience families' text is equal line for
    line."""
    jeng, jreqs, jclock, dt = _stream_scenario(J, "storm")
    _drive(jeng, jreqs, jclock, dt)
    teng, treqs, tclock, _ = _stream_scenario(T, "storm")
    _drive(teng, treqs, tclock, dt)
    skip = ("repro_kernel_route_steps_total",)
    t = {k: v for k, v in parse_text(teng.stats.registry.to_prometheus()).items()
         if not k[0].startswith(skip)}
    j = {k: v for k, v in jmetrics.parse_text(jeng.stats.registry.to_prometheus()).items()
         if not k[0].startswith(skip)}
    assert t == j
    assert sum(v for k, v in t.items() if k[0] == "repro_faults_injected_total") > 0


def test_recovery_trace_determinism_same_seed():
    """Same seed, same trace: the engines run on a VirtualClock advanced 2 ms
    a tick (past the 10 us retry backoff), so the host's clock cannot move
    a retry to another tick."""
    def run(seed):
        R = tresil
        spec = R.FaultSpec(seu_state=0.25, seu_param=0.15, nan=0.25, drop=0.1)
        clock = R.VirtualClock()
        eng = T.stream_engine(slots=2, faults=R.FaultPlan(spec, seed=seed), clock=clock,
                              policy=R.ServePolicy(max_retries=8, backoff_ms=0.01))
        reqs = [eng.submit(_clip(3, seed=i)) for i in range(4)]
        _drive(eng, reqs, clock, 0.002, max_ticks=2000)
        assert all(r.done for r in reqs)
        outs = [tuple(np.asarray(f).tobytes() for f in r.out) for r in reqs]
        return eng.faults.injected, eng.resil_log, outs, eng

    inj_a, log_a, outs_a, eng = run(11)
    inj_b, log_b, outs_b, _ = run(11)
    assert inj_a == inj_b and log_a == log_b and outs_a == outs_b and inj_a
    inj_c, log_c, _, _ = run(12)
    assert (inj_c, log_c) != (inj_a, log_a)
    eng._scrub("final")
    assert eng.params_golden()


def test_faults_imply_guards_imply_policy_and_sentinel_needs_tap():
    eng = T.stream_engine(slots=2, faults=tresil.FaultPlan(tresil.FaultSpec(nan=0.1)))
    assert eng.guards is not None and eng.policy is not None
    bare = T.stream_engine(slots=2)
    assert bare.guards is None and bare.policy is None and bare.resil_log == []
    with pytest.raises(ValueError):
        T.stream_engine(slots=1, guards=tresil.GuardConfig(sentinel_threshold=1.0))


def test_guarded_clean_run_matches_unguarded_bitwise():
    legacy = T.stream_engine(slots=2)
    r0 = legacy.submit(_clip(4))
    legacy.run_until_drained()
    guarded = T.stream_engine(slots=2, guards=tresil.GuardConfig())
    r1 = guarded.submit(_clip(4))
    guarded.run_until_drained()
    assert len(r0.out) == len(r1.out) == 4
    for a, b in zip(r0.out, r1.out):
        np.testing.assert_array_equal(a, b)
    assert guarded.resil_log == []


# ---- the LM workload ------------------------------------------------------

NEW_TOKENS = 4
LOGIT_TOL = 1e-2


def _lm_prompts(n, seed=9, lens=(5, 9, 5, 9, 5, 7)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, lens[i % len(lens)]).astype(np.int32) for i in range(n)]


def _lm_scenario(ns, name, models):
    jm, jp, tm, tp = models
    model, params = (jm, jp) if ns is J else (tm, tp)
    R = ns.resil
    clock = R.VirtualClock()
    kw = dict(slots=2, max_len=32, seed=0)
    if name == "quarantine":
        eng = ns.lm_engine(model, params, faults=_nan_plan(ns, [2]), **kw)
        return eng, [eng.submit(p, NEW_TOKENS) for p in _lm_prompts(3)], None, 0
    if name == "retry_exhaustion":
        eng = ns.lm_engine(model, params, faults=_nan_plan(ns, range(100)),
                           policy=R.ServePolicy(max_retries=2, backoff_ms=0.01), **kw)
        return eng, [eng.submit(p, NEW_TOKENS) for p in _lm_prompts(1)], None, 0
    if name == "deadlines_brownout":
        qos = ns.QoS(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.25,
                     high_water=0.75, cooldown_steps=2)
        eng = ns.lm_engine(model, params, qos=qos, clock=clock, guards=R.GuardConfig(),
                           policy=R.ServePolicy(deadline_ms=9.0, max_queue=3,
                                                brownout=True), **kw)
        return eng, [eng.submit(p, NEW_TOKENS) for p in _lm_prompts(6)], clock, 0.002
    if name == "storm":
        spec = R.FaultSpec(seu_state=0.2, seu_param=0.1, nan=0.2, spike=0.1, drop=0.1)
        eng = ns.lm_engine(model, params, clock=clock, faults=R.FaultPlan(spec, seed=3),
                           policy=R.ServePolicy(max_retries=3, backoff_ms=0.5,
                                                max_queue_age_ms=30.0), **kw)
        return eng, [eng.submit(p, NEW_TOKENS) for p in _lm_prompts(5)], clock, 0.002
    if name == "queue_age_and_drops":
        drops = [R.FaultEvent(tick=t, kind="drop") for t in (1, 2, 5)]
        eng = ns.lm_engine(model, params, clock=clock, faults=R.FaultPlan(events=drops),
                           policy=R.ServePolicy(max_queue_age_ms=7.0), **kw)
        return eng, [eng.submit(p, NEW_TOKENS) for p in _lm_prompts(5)], clock, 0.002
    if name == "chunked_nan":
        adm = ns.Admission(chunk_tokens=8, warmup=False)
        rng = np.random.default_rng(21)
        short = rng.integers(1, 512, 3).astype(np.int32)
        long = rng.integers(1, 512, 40).astype(np.int32)
        eng = ns.lm_engine(model, params, slots=2, max_len=64, seed=11, admission=adm,
                           emitter=False, faults=_nan_plan(ns, [3]),
                           policy=R.ServePolicy(backoff_ms=0.01))
        return eng, [eng.submit(short, 4), eng.submit(long, 4)], None, 0
    raise KeyError(name)


@pytest.mark.parametrize("name", ["quarantine", "retry_exhaustion", "deadlines_brownout",
                                  "storm", "queue_age_and_drops", "chunked_nan"])
def test_lm_engine_matches_reference(name):
    models = P.models("float32", "axq8")
    with P.jax_backend("xla"):
        jeng, jreqs, jclock, dt = _lm_scenario(J, name, models)
        _drive(jeng, jreqs, jclock, dt)
    teng, treqs, tclock, _ = _lm_scenario(T, name, models)
    margins = P.record_margins(teng)
    _drive(teng, treqs, tclock, dt)
    assert _outcome(teng, treqs) == _outcome(jeng, jreqs)
    near_ties = []
    for jr, tr in zip(jreqs, treqs):
        if tr.status != "ok":
            continue
        assert len(tr.out_tokens) == len(jr.out_tokens)
        for i, (a, b) in enumerate(zip(jr.out_tokens, tr.out_tokens)):
            if a != b:
                assert margins[(tr.rid, i)] < LOGIT_TOL, (tr.rid, i, a, b)
                near_ties.append((tr.rid, i))
                break
    assert _resil_text(teng.stats.registry) == _resil_text(jeng.stats.registry)
    assert len(teng.done) == len(treqs) == len({r.rid for r in teng.done})
    if name == "chunked_nan":
        assert [r.retries for r in treqs] == [1, 0]
        assert all(r.status == "ok" for r in treqs)
    if teng.guards is not None:
        teng._scrub("final")
        assert teng.params_golden()
    print(f"near-ties compared by logits instead of tokens: {near_ties}")


def test_lm_guarded_clean_tokens_equal_unguarded():
    jm, jp, tm, tp = P.models("float32", "axq8")
    prompts = _lm_prompts(3)
    outs = []
    for guards in (None, tresil.GuardConfig()):
        eng = TServeEngine(tm, tp, slots=2, max_len=32, guards=guards)
        reqs = [eng.submit(p, NEW_TOKENS) for p in prompts]
        eng.run_until_drained()
        outs.append([r.out_tokens for r in reqs])
        assert eng.resil_log == []
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# what a capturing engine relies on (the card's side: tests/test_torch_gpu.py)
# ---------------------------------------------------------------------------


def _refuse_host_reads(m):
    """Every way a tensor's value reaches the host raises."""
    for name in ("tolist", "item", "__bool__", "__int__", "__float__", "__index__"):
        def refuse(self, *a, _name=name, **k):
            raise AssertionError(f"host read: Tensor.{_name}")
        m.setattr(torch.Tensor, name, refuse)


def test_guarded_steps_read_nothing_on_the_host(monkeypatch):
    """The LM's and the stream's guarded steps — what a guarded engine
    captures — run with every tensor-to-host conversion refused, and give
    the ok bits the fault vector asks for."""
    _, _, tm, tp = P.models("float32", "axq8")
    lm = TServeEngine(tm, tp, slots=3, max_len=16).workload
    cache = lm.init_state(batch=3, max_len=16)
    sad = tstream.StreamAdapter(device="cpu")
    sparams, sstate = sad.init_params(), sad.init_state(batch=3)
    frames = torch.from_numpy(jstream.make_clip(3, _CFG.frame, q=_CFG.q)).to(torch.int32)
    fault = torch.tensor([0.0, float("nan"), float("inf")])
    active = torch.tensor([True, True, False])
    with monkeypatch.context() as m:
        _refuse_host_reads(m)
        tok, _, ok = lm.guarded_step(tp, cache, torch.full((3, 1), 5), active,
                                     torch.Generator().manual_seed(0), None, fault)
        out, _, sok = sad.guarded_step(sparams, sstate, frames, active, None,
                                       torch.tensor([8, 8, 8], dtype=torch.int32), fault)
    assert ok.tolist() == [True, False, False] and sok.tolist() == [True, False, False]
    assert tuple(tok.shape) == (3,) and tuple(out.shape) == (3, _CFG.frame)


@pytest.mark.parametrize("mode", ["pr_emul", "pow2_w"])
def test_emul_decode_step_reads_nothing_on_the_host(mode, monkeypatch):
    from repro_torch.configs import get_config as tget_config
    from repro_torch.core.approx import ApproxMode, ApproxSpec, uniform
    from repro_torch.models import build_model as tbuild_model

    kw = dict(p=1, r=2) if mode == "pr_emul" else {}
    m = tbuild_model(tget_config(P.ARCH), uniform(ApproxSpec(mode=ApproxMode(mode), **kw)),
                     device="cpu")
    params = m.prepack(m.init(seed=0))
    cache = m.init_cache(tp=1, batch=2, max_len=16)
    with monkeypatch.context() as mp:
        _refuse_host_reads(mp)
        logits, _ = m.decode_step(params, cache, torch.tensor([[3], [7]]),
                                  active=torch.tensor([True, True]))
    assert torch.isfinite(logits).all()


def test_storm_keeps_every_address_and_scrubs_in_place():
    """Under a storm the state and every parameter leaf keep their tensors
    and addresses (flips, quarantine resets and scrubs are in place), and
    the final scrub leaves the parameters byte-equal to the golden copy."""
    R = tresil
    spec = R.FaultSpec(seu_state=0.4, seu_param=0.4, nan=0.3, drop=0.1)
    eng = T.stream_engine(slots=2, faults=R.FaultPlan(spec, seed=2),
                          policy=R.ServePolicy(max_retries=8, backoff_ms=0.01))
    state = [(t, t.data_ptr()) for t in eng.state]
    leaves = [(t, t.data_ptr()) for t in tree_leaves(eng.params)]
    golden = [t.data_ptr() for t in eng._golden]
    reqs = [eng.submit(_clip(3, seed=i)) for i in range(5)]
    eng.run_until_drained(max_ticks=2000)
    assert all(r.done for r in reqs)
    kinds = {e.kind for e in eng.faults.injected}
    assert {"seu_state", "seu_param", "nan"} <= kinds
    assert all(a is b and a.data_ptr() == p for (a, p), b in zip(state, eng.state))
    assert all(a is b and a.data_ptr() == p
               for (a, p), b in zip(leaves, tree_leaves(eng.params)))
    assert golden != [p for _, p in leaves]
    eng._scrub("final")
    assert eng.params_golden() and not eng._dirty
