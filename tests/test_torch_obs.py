"""Port parity of the observability layer: ``repro_torch.obs`` (tracer,
metric registry with its Prometheus export, quality tap) against
``repro.obs``, and its wiring into the port's engine, dispatch and launcher.

Mirrors tests/test_obs.py for the tracer and the registry (the port's
``to_prometheus()`` text equals the reference's for the same families), the
engine's lifecycle events, route counters and QoS rung events, and the
quality tap on both workloads: within 1e-4 of the JAX tap on the LM (f32),
and on the stream (whose frames are bit-identical) within 2 f32 ulps where
the tick's squared-error sum is exact in f32 (XLA's f32 log and torch's
differ by an ulp on ~2% of inputs) and 1e-6 relative beyond 2**24 (the two
frameworks sum in different orders).  The tap is a pure
observer: the state after ``sample()`` is bit-identical to the state before
on the bf16, int8 and ring caches, and an engine sampling every tick emits
the same streams as one that never samples.
"""
import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.obs import metrics as jmetrics
from repro.obs import quality as jquality
from repro.obs import trace as jtrace
from repro.serve import stream as jstream
from repro_torch.configs import get_config as tget_config
from repro_torch.core.approx import policy_from_flag as tpolicy
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.kernels import dispatch as tdispatch
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model as tbuild_model
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import quality as tquality
from repro_torch.obs import trace as ttrace
from repro_torch.obs.metrics import Registry, parse_text
from repro_torch.obs.trace import Tracer
from repro_torch.serve import stream as tstream
from repro_torch.serve.lm import ServeEngine
from repro_torch.serve.metrics import EngineStats, summarize
from repro_torch import tune as ttune

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# tracer
# ---------------------------------------------------------------------------


def test_tracer_spans_nest_and_export():
    tr = Tracer(enabled=True)
    with tr.span("outer", track="t", a=1):
        with tr.span("inner", track="t"):
            time.sleep(0.001)
        tr.event("mark", track="t", x=2)
    evs = tr.events
    assert [e["name"] for e in evs] == ["inner", "mark", "outer"]
    inner, outer = evs[0], evs[2]
    assert inner["ph"] == "X" and outer["ph"] == "X" and inner["dur"] > 0
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert evs[1]["ph"] == "i" and evs[1]["args"] == {"x": 2}
    chrome = tr.to_chrome()
    assert any(e["ph"] == "M" and e["args"]["name"] == "t"
               for e in chrome["traceEvents"])
    json.dumps(chrome)
    assert chrome["displayTimeUnit"] == "ms"


def test_tracer_events_have_the_reference_shape():
    """The same calls give events with the same keys, phases and args in
    both tracers (timestamps and pids aside)."""
    def record(mod):
        tr = mod.Tracer(enabled=True)
        with tr.span("s", track="engine", rid=1):
            tr.event("e", track="engine", degrees=[8, 7])
        tr.counter("slots", track="engine", active=2, queued=0)
        return tr.to_chrome()

    def strip(chrome):
        return [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid")}
                for e in chrome["traceEvents"]]

    t, j = record(ttrace), record(jtrace)
    assert strip(t) == strip(j)
    assert t["displayTimeUnit"] == j["displayTimeUnit"]
    assert t["otherData"]["dropped"] == j["otherData"]["dropped"] == 0


def test_tracer_ring_buffer_bounded():
    tr = Tracer(capacity=8, enabled=True)
    for i in range(20):
        tr.event("e", n=i)
    assert len(tr.events) == 8 and tr.dropped == 12
    assert [e["args"]["n"] for e in tr.events] == list(range(12, 20))
    assert tr.to_chrome()["otherData"]["dropped"] == 12


def test_tracer_and_counter_under_threads():
    """Events and counter increments from more threads than cores, with a
    short switch interval: nothing lost (kept + dropped == emitted), the
    ring bound holds, and the counter sums exactly."""
    import os
    import sys
    import threading

    tr = Tracer(capacity=512, enabled=True)
    c = Registry().counter("repro_threads_total", "x")
    n_threads, per = 2 * (os.cpu_count() or 2) + 2, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(per):
                with tr.span("s", track=f"t{k % 3}", i=i):
                    tr.event("e", track=f"t{k % 3}", i=i)
                tr.counter("slots", active=k)
                c.inc()

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    emitted = 3 * n_threads * per
    assert len(tr.events) == 512 and len(tr.events) + tr.dropped == emitted
    assert c.value == n_threads * per
    meta = [e["tid"] for e in tr.to_chrome()["traceEvents"] if e["ph"] == "M"]
    assert sorted(meta) == [1, 2, 3, 4]     # main (the counters) and t0..t2, once each


def test_tracer_disabled_is_noop():
    tr = Tracer(enabled=False)
    with tr.span("s", a=1) as sp:
        pass
    tr.event("e")
    tr.counter("c", v=1)
    assert tr.events == []
    with tr.span("s2") as sp2:
        pass
    assert sp is sp2


def test_tracer_write_and_global_swap(tmp_path):
    old = ttrace.get_tracer()
    try:
        tr = ttrace.set_tracer(Tracer(enabled=True))
        ttrace.span("x")
        ttrace.event("y", track="g")
        p = tmp_path / "trace.json"
        tr.write(p)
        assert any(e["name"] == "y" for e in json.loads(p.read_text())["traceEvents"])
        assert ttrace.enable(capacity=16).capacity == 16
        assert ttrace.disable().enabled is False
    finally:
        ttrace.set_tracer(old)


# ---------------------------------------------------------------------------
# metric registry
# ---------------------------------------------------------------------------


def _families(mod):
    r = mod.Registry()
    c = r.counter("repro_x_total", "things")
    c.inc()
    c.inc(2)
    r.gauge("repro_g", "a gauge").set(1.5)
    lab = r.counter("repro_lab_total", "by site", labels=("site", "backend"))
    lab.labels(site="decode", backend="cuda").inc(4)
    lab.labels(site="prefill", backend="torch").inc(1e16)
    h = r.histogram("repro_h_seconds", "lat", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    q = r.histogram("repro_quality_logit_rms", "by rung", labels=("rung",),
                    buckets=jquality.QUALITY_BUCKETS)
    q.labels(rung="8.7.6").observe(0.0123)
    q.labels(rung="8").observe(1e-6)
    return r


def test_registry_prometheus_roundtrip():
    r = _families(tmetrics)
    d = parse_text(r.to_prometheus())
    assert d[("repro_x_total", ())] == 3
    assert d[("repro_g", ())] == 1.5
    assert d[("repro_lab_total", (("backend", "cuda"), ("site", "decode")))] == 4
    assert d[("repro_h_seconds_bucket", (("le", "0.1"),))] == 1
    assert d[("repro_h_seconds_bucket", (("le", "1"),))] == 2
    assert d[("repro_h_seconds_bucket", (("le", "+Inf"),))] == 3
    assert d[("repro_h_seconds_count", ())] == 3
    assert d[("repro_h_seconds_sum", ())] == pytest.approx(5.55)
    snap = r.snapshot()
    json.dumps(snap)
    assert snap["repro_x_total"]["values"][""] == 3


def test_registry_text_and_snapshot_equal_reference(tmp_path):
    t, j = _families(tmetrics), _families(jmetrics)
    assert t.to_prometheus() == j.to_prometheus()
    assert t.snapshot() == j.snapshot()
    assert parse_text(t.to_prometheus()) == jmetrics.parse_text(j.to_prometheus())
    t.write(tmp_path / "t.prom")
    j.write(tmp_path / "j.prom")
    assert (tmp_path / "t.prom").read_bytes() == (tmp_path / "j.prom").read_bytes()


def test_registry_idempotent_and_conflicts():
    r = Registry()
    a = r.counter("repro_dup_total", "x")
    assert r.counter("repro_dup_total", "x") is a
    with pytest.raises(ValueError):
        r.gauge("repro_dup_total", "now a gauge")
    with pytest.raises(ValueError):
        r.counter("repro_dup_total", "x", labels=("site",))
    with pytest.raises(ValueError):
        r.counter("0bad name")
    with pytest.raises(ValueError):
        r.counter("repro_neg_total").inc(-1)
    with pytest.raises(ValueError):
        parse_text("not a sample line at all\n")


def test_labelled_family_interning():
    f = Registry().counter("repro_l_total", "x", labels=("site",))
    f.labels(site="a").inc()
    f.labels(site="a").inc()
    f.labels(site="b").inc()
    assert f.labels(site="a").value == 2 and f.labels(site="b").value == 1
    with pytest.raises(ValueError):
        f.labels(wrong="a")
    with pytest.raises(ValueError):
        f.inc()


def test_global_registry_swap():
    old = tmetrics.get_registry()
    try:
        fresh = tmetrics.set_registry(None)
        assert tmetrics.get_registry() is fresh and fresh is not old
        mine = Registry()
        assert tmetrics.set_registry(mine) is mine
    finally:
        tmetrics.set_registry(old)


def test_engine_stats_registry_view():
    st_ = EngineStats()
    st_.c_decode_steps.inc(3)
    st_.c_prefill_tokens.inc(7)
    assert st_.decode_steps == 3 and st_.prefill_tokens == 7
    assert st_.record_degree(0, 6) == (6,)
    assert st_.degree_history[-1] == (0, (6,))
    d = parse_text(st_.registry.to_prometheus())
    assert d[("repro_decode_steps_total", ())] == 3
    assert d[("repro_degree_ebits", (("site", "global"),))] == 6
    shared = Registry()
    assert EngineStats(shared).registry is shared


# ---------------------------------------------------------------------------
# dispatch route publication
# ---------------------------------------------------------------------------


def test_dispatch_publishes_a_route_once_per_backend_change():
    old_reg, old_tr = tmetrics.get_registry(), ttrace.get_tracer()
    saved = dict(tdispatch.last_route)
    try:
        reg = tmetrics.set_registry(None)
        tr = ttrace.set_tracer(Tracer(enabled=True))
        tdispatch.last_route.clear()
        x = torch.randn(4, 64)
        w = torch.randn(64, 8)
        for _ in range(3):
            tdispatch.axq_matmul(x, w, block=64, ebits=8)
        fam = reg.get("repro_kernel_route_trace_total")
        assert fam.labels(site="gemm", backend="torch").value == 1
        evs = [e for e in tr.events if e["name"] == "kernel_route_trace"]
        assert [e["args"] for e in evs] == [{"site": "gemm", "backend": "torch"}]
        tdispatch.last_route["gemm"] = "cuda"    # as after a call on the card
        tdispatch.axq_matmul(x, w, block=64, ebits=8)
        assert fam.labels(site="gemm", backend="torch").value == 2
        assert tdispatch.last_route["gemm"] == "torch"
    finally:
        tmetrics.set_registry(old_reg)
        ttrace.set_tracer(old_tr)
        tdispatch.last_route.clear()
        tdispatch.last_route.update(saved)


# ---------------------------------------------------------------------------
# engine trace validation
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def _model(arch="tinyllama-1.1b-smoke", approx="axq8"):
    key = (arch, approx)
    if key not in _MODELS:
        m = tbuild_model(tget_config(arch), tpolicy(approx, dynamic=True), device="cpu")
        _MODELS[key] = (m, m.prepack(m.init(seed=0)))
    return _MODELS[key]


def _events(tracer, name):
    return [e for e in tracer.events if e["name"] == name]


def test_engine_trace_lifecycle_and_route_counters():
    m, params = _model()
    tr = Tracer(enabled=True)
    reg = Registry()
    eng = ServeEngine(m, params, slots=2, max_len=64, registry=reg, tracer=tr)
    assert eng.stats.registry is reg
    for _ in range(4):
        eng.submit(np.array([1, 2, 3]), max_new_tokens=4)
    done = eng.run_until_drained()
    assert len(done) == 4
    rids = {r.rid for r in done}
    for name in ("enqueue", "prefill", "first_token", "request_done"):
        assert {e["args"]["rid"] for e in _events(tr, name)} == rids, name
    pre = _events(tr, "prefill")
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in pre)
    assert all(e["args"]["prompt_tokens"] == 3 for e in pre)
    enq = _events(tr, "enqueue")
    assert all(e["args"]["max_new_tokens"] == 4 for e in enq)
    t_enq = {e["args"]["rid"]: e["ts"] for e in enq}
    t_ft = {e["args"]["rid"]: e["ts"] for e in _events(tr, "first_token")}
    for e in pre:
        rid = e["args"]["rid"]
        assert t_enq[rid] <= e["ts"] + e["dur"] <= t_ft[rid]
    assert all(e["args"] == {"rid": e["args"]["rid"], "slot": e["args"]["slot"],
                             "e2e_ms": e["args"]["e2e_ms"], "eos": False, "tokens": 4}
               for e in _events(tr, "request_done"))
    assert len(_events(tr, "decode_tick")) == eng.stats.decode_steps
    assert len(_events(tr, "slots")) == eng.stats.decode_steps
    by_site: dict = {}
    for (site, backend), child in eng.stats.c_route_steps.children.items():
        by_site[site] = by_site.get(site, 0) + child.value
        assert backend in {"cuda", "torch"}
    assert by_site["decode"] == eng.stats.decode_steps
    assert by_site["prefill"] == eng.stats.prefill_calls
    routes = _events(tr, "kernel_route")
    assert {e["args"]["site"] for e in routes} == {"decode", "prefill"}
    assert {e["args"]["backend"] for e in routes} <= {"cuda", "torch"}


def test_engine_admission_pipeline_spans():
    from repro_torch.serve.admission import AdmissionConfig

    m, params = _model()
    tr = Tracer(enabled=True)
    eng = ServeEngine(m, params, slots=2, max_len=64, tracer=tr,
                      admission=AdmissionConfig(buckets=(8, 16), pack=2, chunk_tokens=8))
    warm = _events(tr, "admission_warmup")
    assert len(warm) == 1 and warm[0]["args"] == {"buckets": [8, 16], "pack": 2, "chunk": 8}
    eng.submit(np.arange(1, 5), 3)
    eng.submit(np.arange(1, 30), 3)            # chunked
    eng.run_until_drained()
    pre = _events(tr, "prefill")
    assert any(e["args"].get("chunk") for e in pre)
    assert any("packed" in e["args"] for e in pre)
    by_site = {k[0]: c.value for k, c in eng.stats.c_route_steps.children.items()}
    assert by_site["prefill"] == eng.stats.prefill_calls


def test_engine_qos_rung_events_carry_degrees():
    m, params = _model()
    tr = Tracer(enabled=True)
    qos = TQoS(ladder=[{"ebits": 8}, {"ebits": 6}], low_water=0.5, high_water=0.9,
               cooldown_steps=0)
    eng = ServeEngine(m, params, slots=2, max_len=64, qos=qos, tracer=tr)
    for _ in range(6):
        eng.submit(np.array([1, 2, 3]), 8)
    done = eng.run_until_drained()
    rungs = _events(tr, "qos_rung")
    assert rungs, "overload never moved the QoS rung"
    for e in rungs:
        assert isinstance(e["args"]["degrees"], list) and e["args"]["degrees"]
        assert 0.0 <= e["args"]["headroom"] <= 1.0
    assert any(e["args"]["degrees"] == [6] for e in rungs)
    assert all(r.degree_at_first_token in {(8,), (6,)} for r in done)
    s = summarize(done, eng.stats)
    assert sum(s["degree_at_first_token"].values()) == len(done)


def test_engine_plan_rung_events_carry_the_site_vector():
    m, params = _model()
    cfg = m.cfg
    plan = ttune.uniform_plan(cfg, ebits_ladder=(8, 6, 5))
    plan.ladder[1] = ttune.PlanPoint("mixed", (8, 6, 7), 0.1, 0.9)
    tr = Tracer(enabled=True)
    qos = TQoS(ladder=[], low_water=0.5, high_water=0.9, cooldown_steps=0)
    eng = ServeEngine(m, params, slots=2, max_len=64, qos=qos, plan=plan, tracer=tr)
    for _ in range(8):
        eng.submit(np.array([1, 2, 3]), 6)
    eng.run_until_drained()
    rungs = _events(tr, "qos_rung")
    assert rungs and all(len(e["args"]["degrees"]) == cfg.n_layers + 1 for e in rungs)
    assert {tuple(e["args"]["degrees"]) for e in rungs} <= {p.degrees for p in plan.ladder}
    d = parse_text(eng.stats.registry.to_prometheus())
    sites = {dict(k[1])["site"] for k in d if k[0] == "repro_degree_ebits"}
    assert sites == {"layer_0", "layer_1", "head"}


def test_engine_disabled_tracer_records_nothing():
    m, params = _model()
    tr = Tracer(enabled=False)
    eng = ServeEngine(m, params, slots=2, max_len=64, tracer=tr, degree=6,
                      quality_every=1)
    eng.submit(np.array([1, 2, 3]), 4)
    eng.run_until_drained()
    assert tr.events == []
    assert eng.stats.decode_steps > 0 and eng._tap.samples == eng.stats.decode_steps


def test_engine_uses_the_global_tracer_by_default():
    m, params = _model()
    old = ttrace.get_tracer()
    try:
        tr = ttrace.set_tracer(Tracer(enabled=True))
        eng = ServeEngine(m, params, slots=2, max_len=64)
        eng.submit(np.array([1, 2]), 2)
        eng.run_until_drained()
        assert len(_events(tr, "decode_tick")) == eng.stats.decode_steps
    finally:
        ttrace.set_tracer(old)


# ---------------------------------------------------------------------------
# quality tap
# ---------------------------------------------------------------------------


def test_quality_tap_records_per_rung():
    m, params = _model()
    tr = Tracer(enabled=True)
    eng = ServeEngine(m, params, slots=2, max_len=64, degree=6, quality_every=2,
                      prepack=False, tracer=tr)
    eng.submit(np.array([1, 2, 3]), 8)
    eng.run_until_drained()
    assert eng._tap is not None and eng._tap.samples > 0
    child = eng.stats.registry.get("repro_quality_logit_rms").labels(rung="6")
    assert child.count == eng._tap.samples and child.sum > 0
    assert eng.stats.registry.get("repro_quality_probes_total").value == eng._tap.samples
    probes = _events(tr, "quality_probe")
    assert len(probes) == eng._tap.samples
    assert all(e["args"]["rung"] == "6" and e["args"]["logit_rms"] > 0 for e in probes)


def test_stream_quality_tap_records_per_rung():
    tr = Tracer(enabled=True)
    qos = TQoS(ladder=[{"degrees": [e] * 3} for e in (8, 6)], low_water=0.5,
               high_water=0.9, cooldown_steps=0)
    eng = tstream.StreamServeEngine(tstream.StreamAdapter(device="cpu"), slots=2,
                                    qos=qos, quality_every=1, tracer=tr)
    for i in range(5):
        eng.submit(tstream.make_clip(3, 256, seed=i))
    eng.run_until_drained()
    hist = eng.stats.registry.get("repro_quality_psnr_db")
    labels = {k[0] for k in hist.children}
    assert labels <= {"8.8.8", "6.6.6"} and "6.6.6" in labels
    assert sum(c.count for c in hist.children.values()) == eng._tap.samples
    assert eng._tap.samples == eng.stats.decode_steps
    exact = hist.children.get(("8.8.8",))
    if exact is not None:              # the exact rung probes at the PSNR cap
        assert exact.sum == pytest.approx(exact.count * 180.0, rel=1e-6)
    assert {e["args"]["rung"] for e in _events(tr, "quality_probe")} == labels


def test_quality_tap_requires_a_driven_degree():
    m, params = _model()
    with pytest.raises(ValueError, match="quality_every"):
        ServeEngine(m, params, slots=2, max_len=64, quality_every=4)
    with pytest.raises(ValueError, match="period"):
        tquality.QualityTap(m, every=0)
    with pytest.raises(ValueError, match="model or a custom probe"):
        tquality.QualityTap(every=2)


def test_rung_label():
    assert tquality.rung_label(np.int32(8)) == "8"
    assert tquality.rung_label(np.array([8, 7, 6])) == "8.7.6"
    assert tquality.rung_label((8, 7, 6)) == jquality.rung_label(np.array([8, 7, 6]))
    assert tquality.rung_label(torch.tensor(5, dtype=torch.int32)) == "5"
    assert tquality.QUALITY_BUCKETS == jquality.QUALITY_BUCKETS


@pytest.mark.parametrize("degree_kind", [6, "vector"])
def test_lm_quality_tap_matches_reference(degree_kind):
    """The port's logit-RMS tap against the JAX tap on the same state: the
    smoke model in f32 under axq8, a JAX cache with two prompts in converted
    through numpy, one slot free; the JAX side on its Pallas route."""
    jm, jp, tm, tp = P.models("float32", "axq8")
    jdeg, tdeg = P.degrees(degree_kind)
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 512, (3, 1)).astype(np.int32)
    active = np.array([True, False, True])
    with P.jax_backend("pallas"):
        jc = jm.init_cache(tp=1, batch=3, max_len=32, dtype=jnp.float32)
        for slot, n in ((0, 7), (2, 12)):
            _, jc = jm.prefill(jp, jc, jnp.asarray(rng.integers(0, 512, n), jnp.int32),
                               jnp.int32(slot))
        tc = P.port_cache(jc)
        jtap = jquality.QualityTap(jm, every=1, registry=jmetrics.Registry(),
                                   tracer=jtrace.Tracer())
        jv = jtap.sample(0, jp, jc, toks, active, jdeg)
    ttap = tquality.QualityTap(tm, every=1, registry=Registry(), tracer=Tracer())
    tv = ttap.sample(0, tp, tc, torch.from_numpy(toks).long(), torch.from_numpy(active),
                     tdeg)
    assert tv > 0 and abs(tv - jv) <= 1e-4, (tv, jv)
    assert ttap.hist.labels(rung=jquality.rung_label(jdeg)).count == 1


STREAM_RUNGS = ([8, 8, 8], [7, 7, 7], [6, 6, 6], [8, 6, 8])


@pytest.mark.parametrize("deg", STREAM_RUNGS + ([8, 4, 5],), ids=str)
def test_stream_quality_tap_matches_reference(deg):
    """The PSNR tap against the JAX tap on the same stream state (frames
    bit-identical): within 2 f32 ulps where the squared-error sum is exact
    in f32, within 1e-6 relative where it is not (different summation
    orders)."""
    ja, ta = jstream.StreamAdapter(), tstream.StreamAdapter(device="cpu")
    jp, tp = ja.init_params(), ta.init_params()
    rng = np.random.default_rng(0)
    B = 4
    tail = rng.integers(-4096, 4096, (1, B, 7)).astype(np.int32)
    feed = np.stack([tstream.make_clip(1, 256, seed=10 + i)[0] for i in range(B)])
    active = np.array([True, False, True, True])
    js = jstream.StreamState(length=jnp.zeros((B,), jnp.int32), tail=jnp.asarray(tail))
    ts = tstream.StreamState(length=torch.zeros((B,), dtype=torch.int32),
                             tail=torch.from_numpy(tail.copy()))
    jtap = ja.quality_tap(every=1, registry=jmetrics.Registry(), tracer=jtrace.Tracer())
    ttap = ta.quality_tap(every=1, registry=Registry(), tracer=Tracer())
    jv = jtap.sample(0, jp, js, feed, active, jnp.asarray(deg, jnp.int32))
    tv = ttap.sample(0, tp, ts, torch.from_numpy(feed), torch.from_numpy(active),
                     torch.tensor(deg, dtype=torch.int32))
    a, _ = ja.step(jp, js, jnp.asarray(feed), jnp.asarray(active), None,
                   jnp.asarray(deg, jnp.int32))
    e, _ = ja.step(jp, js, jnp.asarray(feed), jnp.asarray(active), None,
                   jnp.full((3,), 8, jnp.int32))
    sq = int(((np.asarray(a - e).astype(np.int64) ** 2) * active[:, None]).sum())
    if sq < 2 ** 24:
        # the same f32 error; XLA's f32 log and torch's differ by an ulp on
        # ~2% of inputs, so the dB value may sit an ulp or two apart
        np.testing.assert_array_max_ulp(np.float32(tv), np.float32(jv), maxulp=2)
    else:
        assert deg == [8, 4, 5]
        assert tv == pytest.approx(jv, rel=1e-6)
    assert sq < 2 ** 24 or deg not in STREAM_RUNGS


# ---- the tap is a pure observer --------------------------------------------


def _snapshot(state):
    return [t.clone() for t in state]


def _filled_engine(arch, quant, prompt_len, max_len):
    import os

    m, params = _model(arch)
    prev = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if quant else "0"
    try:
        eng = ServeEngine(m, params, slots=3, max_len=max_len, degree=5, quality_every=1)
    finally:
        if prev is None:
            del os.environ["REPRO_KV_INT8"]
        else:
            os.environ["REPRO_KV_INT8"] = prev
    rng = np.random.default_rng(prompt_len)
    for n in (prompt_len, prompt_len // 2):
        eng.submit(rng.integers(0, m.cfg.vocab, n), 40)
    eng.tick()
    eng.tick()
    return eng


@pytest.mark.parametrize("kind", ["bf16", "int8", "ring"])
def test_quality_tap_leaves_the_cache_bit_identical(kind):
    arch = "h2o-danube-1.8b-smoke" if kind == "ring" else "tinyllama-1.1b-smoke"
    # ring: window 32 at smoke size, prompts past it, so the probe's row wraps
    eng = _filled_engine(arch, kind == "int8", 45 if kind == "ring" else 11, 64)
    cache = eng.state
    assert cache.k.dtype == (torch.int8 if kind == "int8" else torch.bfloat16)
    if kind == "ring":
        assert cache.k.shape[2] == eng.workload.cfg.swa_window == 32
        assert int(cache.length.max()) > 32
    before = _snapshot(cache)
    mask = torch.tensor([True, True, False])
    feed = torch.from_numpy(eng._feed)
    for deg in (eng._degree, torch.tensor([8, 4, 6], dtype=torch.int32)):
        val = eng._tap.sample(0, eng.params, cache, feed, mask, deg)
        assert np.isfinite(val) and val > 0
        for a, b in zip(before, cache):
            assert torch.equal(a, b)
    assert eng.state is cache


@pytest.mark.parametrize("arch", ["tinyllama-1.1b-smoke", "h2o-danube-1.8b-smoke"])
def test_quality_tap_does_not_change_the_streams(arch):
    m, params = _model(arch)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, m.cfg.vocab, int(rng.integers(3, 40))) for _ in range(5)]

    def run(every):
        qos = TQoS(ladder=[{"ebits": e} for e in (8, 6, 5)], low_water=0.5,
                   high_water=0.9, cooldown_steps=1)
        eng = ServeEngine(m, params, slots=2, max_len=64, qos=qos, quality_every=every)
        reqs = [eng.submit(p, 12) for p in prompts]
        eng.run_until_drained()
        return [r.out_tokens for r in reqs], eng

    with_tap, eng = run(1)
    without, _ = run(0)
    assert with_tap == without
    assert eng._tap.samples == eng.stats.decode_steps


def test_stream_quality_tap_does_not_change_the_frames():
    clips = [tstream.make_clip(4, 256, seed=i) for i in range(5)]

    def run(every):
        qos = TQoS(ladder=[{"degrees": [e] * 3} for e in (8, 6, 5)], low_water=0.5,
                   high_water=0.9, cooldown_steps=1)
        eng = tstream.StreamServeEngine(tstream.StreamAdapter(device="cpu"), slots=2,
                                        qos=qos, quality_every=every)
        reqs = [eng.submit(c) for c in clips]
        eng.run_until_drained()
        return [np.stack(r.out) for r in reqs]

    for a, b in zip(run(1), run(0)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_obs():
    """A fresh global registry and tracer and no route seen yet, as in a new
    launcher process."""
    old_reg, old_tr = tmetrics.get_registry(), ttrace.get_tracer()
    routes = dict(tdispatch.last_route)
    tmetrics.set_registry(None)
    ttrace.set_tracer(None)
    tdispatch.last_route.clear()
    yield
    tmetrics.set_registry(old_reg)
    ttrace.set_tracer(old_tr)
    tdispatch.set_backend(None)
    tdispatch.last_route.clear()
    tdispatch.last_route.update(routes)


def _plan_file(tmp_path, plan):
    return str(plan.save(tmp_path / "plan.json"))


def test_launch_serve_lm_plan_trace_metrics_quality(tmp_path, fresh_obs, capsys):
    cfg = tget_config("tinyllama-1.1b-smoke")
    plan = ttune.uniform_plan(cfg, ebits_ladder=(8, 6, 5))
    plan.ladder[1] = ttune.PlanPoint("mixed", (8, 6, 7), 0.1, 0.9)
    trace_p, metrics_p = tmp_path / "t.json", tmp_path / "m.prom"
    s, eng = launch_serve.run([
        "--device", "cpu", "--plan", _plan_file(tmp_path, plan), "--qos",
        "--quality-every", "2", "--trace-out", str(trace_p), "--metrics-out",
        str(metrics_p), "--requests", "6", "--new-tokens", "5", "--slots", "2",
        "--approx", "exact"])
    assert s["requests"] == 6 and s["generated_tokens"] == 30
    assert eng.plan.to_dict() == plan.to_dict()
    assert eng.workload.model.policy == plan.policy(dynamic=True)   # --approx ignored
    assert "wrote Chrome trace" in capsys.readouterr().out
    evs = json.loads(trace_p.read_text())["traceEvents"]
    ticks = [e for e in evs if e["name"] == "decode_tick"]
    assert len(ticks) == eng.stats.decode_steps
    rungs = [e for e in evs if e["name"] == "qos_rung"]
    assert rungs and all(len(e["args"]["degrees"]) == 3 for e in rungs)
    d = parse_text(metrics_p.read_text())
    assert d[("repro_decode_steps_total", ())] == eng.stats.decode_steps
    assert {dict(k[1])["site"] for k in d if k[0] == "repro_degree_ebits"} == \
        {"layer_0", "layer_1", "head"}
    route = sum(v for k, v in d.items() if k[0] == "repro_kernel_route_steps_total"
                and dict(k[1])["site"] == "decode")
    assert route == eng.stats.decode_steps
    counts = sum(v for k, v in d.items() if k[0] == "repro_quality_logit_rms_count")
    assert counts == eng._tap.samples == d[("repro_quality_probes_total", ())] > 0
    assert sum(1 for e in evs if e["name"] == "quality_probe") == eng._tap.samples
    # the dispatch counters co-export in the same file
    assert any(k[0] == "repro_kernel_route_trace_total" for k in d)


def test_launch_serve_stream_plan_trace_metrics_quality(tmp_path, fresh_obs):
    ta = tstream.StreamAdapter(device="cpu")
    batch = {"frames": np.stack([tstream.make_clip(3, 256, seed=i) for i in range(2)])}
    plan = ttune.build_plan(ta, ta.init_params(), batch, grid=(8, 6, 4),
                            metric=tstream.psnr_metric, max_rungs=4)
    trace_p, metrics_p = tmp_path / "t.json", tmp_path / "m.prom"
    s, eng = launch_serve.run([
        "--workload", "stream", "--device", "cpu", "--plan", _plan_file(tmp_path, plan),
        "--qos", "--quality-every", "3", "--trace-out", str(trace_p),
        "--metrics-out", str(metrics_p), "--requests", "6", "--frames", "4",
        "--slots", "2"])
    assert s["requests"] == 6 and s["generated_tokens"] == 24
    evs = json.loads(trace_p.read_text())["traceEvents"]
    assert len([e for e in evs if e["name"] == "stream_tick"]) == eng.stats.decode_steps
    assert len([e for e in evs if e["name"] == "first_frame"]) == 6
    d = parse_text(metrics_p.read_text())
    counts = sum(v for k, v in d.items() if k[0] == "repro_quality_psnr_db_count")
    assert counts == eng._tap.samples > 0
    routes = {dict(k[1])["site"]: v for k, v in d.items()
              if k[0] == "repro_kernel_route_steps_total"}
    assert routes == {"fir": eng.stats.decode_steps, "conv2d": eng.stats.decode_steps}
    assert {tuple(dg) for _, dg in eng.stats.degree_history} <= \
        {p.degrees for p in plan.ladder}


def test_launch_serve_refuses_a_plan_of_another_arch(tmp_path, fresh_obs):
    plan = ttune.uniform_plan(tget_config("qwen2.5-3b-smoke"))
    with pytest.raises(ValueError, match="tuned for"):
        launch_serve.main(["--device", "cpu", "--plan", _plan_file(tmp_path, plan),
                           "--requests", "1"])
    with pytest.raises(ValueError, match="tuned for"):
        launch_serve.main(["--workload", "stream", "--device", "cpu", "--plan",
                           _plan_file(tmp_path, plan), "--requests", "1"])
