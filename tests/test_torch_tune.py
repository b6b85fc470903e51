"""Port parity of per-layer approximation plans: ``repro_torch.tune`` (with
``core/area_model.py`` and ``core/pareto.py``) against ``repro.tune`` in the
same process.

  * the cost model (unit-gate energy proxy, per-site MACs, vector costs)
    and the Pareto mask equal the reference's float for float / bit for bit;
  * plan files cross between the packages both ways with equal ``to_dict()``,
    and ``validate_for`` refuses the same mismatches;
  * ``build_plan`` on tinyllama-1.1b-smoke (f32, axq8 dynamic, params
    converted through ``repro_torch.convert``, exhaustive grid (8, 6, 4): 27
    vectors) gives the reference's ladder — the JAX side on its Pallas route
    in interpret mode — with costs equal and errors within 1e-3 relative
    (they agree to ~1e-6: the f32 forwards differ in the last ulps);
  * ``build_plan`` on the stream workload with ``psnr_metric`` equals the
    reference's plan field for field but ``meta.tune_seconds`` (integer
    pipeline);
  * an engine under a plan serves every rung's vector as ``degree=`` by hand
    does, and as the JAX engine under the same plan; the QoS walk over the
    ladder meets no new call shape.
"""
import dataclasses
import itertools
import math

import jax
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.core import area_model as jarea
from repro.core import pareto as jpareto
from repro.core.dynamic import QoSController as JQoS
from repro.models import build_model as jbuild_model
from repro.serve import stream as jstream
from repro.serve.engine import ServeEngine as JServeEngine
from repro import tune as jtune
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import area_model as tarea
from repro_torch.core import pareto as tpareto
from repro_torch.core.dynamic import QoSController as TQoS
from repro_torch.models import build_model as tbuild_model
from repro_torch.serve import stream as tstream
from repro_torch.serve.lm import ServeEngine as TServeEngine
from repro_torch import tune as ttune

torch.set_num_threads(2)

ARCH = "tinyllama-1.1b-smoke"
GRID = (8, 6, 4)


def _all_archs():
    return [n for name in jlist_configs() for n in (name, name + "-smoke")]


# ---------------------------------------------------------------------------
# cost model and Pareto mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", ["CMB", "PERF", "ROUND", "PR", "RAD", "ROUP"])
def test_area_and_energy_equal_reference(fam):
    for n in (8, 16, 32):
        for k, p, r in itertools.product((0, 2, 4, 8), (0, 1, 2), (0, 2, 4, 7)):
            if fam in ("RAD", "ROUP") and k >= n:
                continue
            a = tarea.area_of(fam, n, k, p, r)
            assert a == jarea.area_of(fam, n, k, p, r)
            e = tarea.energy_proxy(fam, n, k, p, r)
            assert e == jarea.energy_proxy(fam, n, k, p, r)
    assert tarea.dlsb_overhead_table() == jarea.dlsb_overhead_table()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_front_mask_equals_reference(seed):
    rng = np.random.default_rng(seed)
    n = 60
    # quantized values, so ties and duplicated points occur
    xs = np.round(rng.uniform(0, 1, n), 1).tolist()
    ys = np.round(rng.uniform(0, 1, n), 1).tolist()
    xs[5], ys[5] = xs[4], ys[4]
    assert tpareto.front_mask(xs, ys) == jpareto.front_mask(xs, ys)
    pts_t = tpareto.explore(n=8, num_samples=1 << 10, seed=seed)
    pts_j = jpareto.explore(n=8, num_samples=1 << 10, seed=seed)
    assert [(p.name, p.mred, p.energy, p.on_front) for p in pts_t] == \
        [(p.name, p.mred, p.energy, p.on_front) for p in pts_j]


@pytest.mark.parametrize("arch", _all_archs())
def test_cost_model_equals_reference(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    assert ttune.site_macs(tcfg) == jtune.site_macs(jcfg)
    S = tcfg.n_layers + 1
    rng = np.random.default_rng(S)
    for e in range(1, 9):
        assert ttune.energy_per_mac(e) == jtune.energy_per_mac(e)
    for vec in ([8] * S, [5] * S, rng.integers(1, 9, S).tolist()):
        assert ttune.vector_cost(tcfg, vec) == jtune.vector_cost(jcfg, vec)
    assert ttune.site_names(tcfg) == jtune.site_names(jcfg)


def test_stream_cost_model_equals_reference():
    tcfg, jcfg = tstream.StreamConfig(), jstream.StreamConfig()
    assert ttune.site_macs(tcfg) == jtune.site_macs(jcfg) == tcfg.site_macs()
    for vec in ([8, 8, 8], [6, 4, 8], [1, 2, 3]):
        assert ttune.vector_cost(tcfg, vec) == jtune.vector_cost(jcfg, vec)


# ---------------------------------------------------------------------------
# plan files
# ---------------------------------------------------------------------------


def _handmade(pkg, cfg):
    """A plan with every field set, built the same way in either package."""
    S = cfg.n_layers + 1
    ladder = [pkg.PlanPoint(name=f"rung_{r}", degrees=tuple([8 - r] * (S - 1) + [8]),
                            error=0.1 * r + 1e-17, cost=1.0 - 0.07 * r)
              for r in range(3)]
    return pkg.ApproxPlan(arch=cfg.name, sites=pkg.site_names(cfg), ladder=ladder,
                          block=64, sensitivity={"layer_0": {6: 0.25, 4: 1 / 3}},
                          meta={"grid": [8, 6, 4], "tune_seconds": 0.5})


def test_plan_files_cross_between_packages(tmp_path):
    cfg_j, cfg_t = jget_config(ARCH), tget_config(ARCH)
    jplan, tplan = _handmade(jtune, cfg_j), _handmade(ttune, cfg_t)
    assert jplan.to_dict() == tplan.to_dict()
    # JAX writes, the port reads
    loaded = ttune.ApproxPlan.load(jplan.save(tmp_path / "j.json"))
    assert loaded.to_dict() == jplan.to_dict() and loaded == tplan
    loaded.validate_for(cfg_t)
    # the port writes, JAX reads; the bytes are the same file
    tpath = tplan.save(tmp_path / "t.json")
    back = jtune.ApproxPlan.load(tpath)
    assert back.to_dict() == tplan.to_dict() and back == jplan
    assert tpath.read_bytes() == (tmp_path / "j.json").read_bytes()
    # degrees stay ints, the policy is the port's uniform dynamic AXQ
    assert isinstance(loaded.ladder[0].degrees[0], int)
    pol = loaded.policy()
    assert pol.default.mode.value == "axq" and pol.default.dynamic
    assert pol.default.block == 64
    assert loaded.qos_ladder() == jplan.qos_ladder()
    np.testing.assert_array_equal(loaded.degrees(2), jplan.degrees(2))


def test_uniform_plan_equals_reference():
    for arch in (ARCH, "qwen2.5-3b-smoke"):
        t = ttune.uniform_plan(tget_config(arch), ebits_ladder=(8, 6))
        j = jtune.uniform_plan(jget_config(arch), ebits_ladder=(8, 6))
        assert t.to_dict() == j.to_dict()
    s = ttune.uniform_plan(tstream.StreamConfig())
    assert s.sites == ["fir", "conv2d", "gain"]
    assert s.to_dict() == jtune.uniform_plan(jstream.StreamConfig()).to_dict()


@pytest.mark.parametrize("pkg,get_config", [(ttune, tget_config), (jtune, jget_config)],
                         ids=["port", "reference"])
def test_validate_for_refuses_the_same_mismatches(pkg, get_config):
    """Mirrors tests/test_tune.py::test_plan_validate_mismatch in both
    packages: the same calls raise with the same messages."""
    cfg = get_config(ARCH)
    plan = pkg.uniform_plan(cfg)
    plan.validate_for(cfg)
    with pytest.raises(ValueError, match="tuned for"):
        plan.validate_for(get_config("recurrentgemma-2b-smoke"))
    with pytest.raises(ValueError, match="tuned for"):
        plan.validate_for(get_config("tinyllama-1.1b"))     # smoke plan, full arch
    bad = pkg.ApproxPlan(arch=cfg.name, sites=pkg.site_names(cfg)[:-1],
                         ladder=pkg.uniform_plan(cfg).ladder)
    with pytest.raises(ValueError, match="sites"):
        bad.validate_for(cfg)
    with pytest.raises(ValueError, match="empty ladder"):
        pkg.ApproxPlan(arch=cfg.name, sites=pkg.site_names(cfg), ladder=[]).validate_for(cfg)
    short = pkg.ApproxPlan(arch=cfg.name, sites=pkg.site_names(cfg),
                           ladder=[pkg.PlanPoint("r", (8, 8), 0.0, 1.0)])
    with pytest.raises(ValueError, match="degrees, needs"):
        short.validate_for(cfg)
    with pytest.raises(ValueError, match="newer"):
        pkg.ApproxPlan.from_dict({**plan.to_dict(), "version": 99})


def test_port_plan_validation_matches_reference_messages():
    cfg_t, cfg_j = tget_config(ARCH), jget_config(ARCH)
    other_t, other_j = tget_config("tinyllama-1.1b"), jget_config("tinyllama-1.1b")
    with pytest.raises(ValueError) as et:
        ttune.uniform_plan(cfg_t).validate_for(other_t)
    with pytest.raises(ValueError) as ej:
        jtune.uniform_plan(cfg_j).validate_for(other_j)
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# build_plan
# ---------------------------------------------------------------------------

_PLANS: dict = {}


def _lm_models():
    """The smoke arch in f32 under the plan policy (uniform dynamic AXQ),
    JAX params from a seed converted through numpy (float weights: the
    exact-policy twin needs them)."""
    if "lm" not in _PLANS:
        jcfg = dataclasses.replace(jget_config(ARCH), dtype="float32")
        tcfg = dataclasses.replace(tget_config(ARCH), dtype="float32")
        jm = jbuild_model(jcfg, jtune.uniform_plan(jcfg).policy())
        tm = tbuild_model(tcfg, ttune.uniform_plan(tcfg).policy(), device="cpu")
        jp = jm.init(jax.random.PRNGKey(0), tp=1)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp))
        _PLANS["lm"] = (jm, jp, tm, tp)
    return _PLANS["lm"]


def _lm_plans():
    if "lm_plans" not in _PLANS:
        jm, jp, tm, tp = _lm_models()
        rng = np.random.default_rng(7)
        batch = {"tokens": rng.integers(0, jm.cfg.vocab, (2, 16)).astype(np.int32)}
        with P.jax_backend("pallas"):
            jplan = jtune.build_plan(jm, jp, batch, grid=GRID)
        prober = ttune.autotune._Prober(tm, tp, batch)
        tplan = ttune.build_plan(tm, tp, batch, grid=GRID, prober=prober)
        _PLANS["lm_plans"] = (jplan, tplan, prober)
    return _PLANS["lm_plans"]


def test_build_plan_lm_matches_reference_ladder():
    jplan, tplan, prober = _lm_plans()
    assert tplan.meta["strategy"] == "exhaustive" and tplan.meta["visited"] == 27
    assert prober.probes == 27
    assert [p.degrees for p in tplan.ladder] == [p.degrees for p in jplan.ladder]
    assert [p.name for p in tplan.ladder] == [p.name for p in jplan.ladder]
    for a, b in zip(tplan.ladder, jplan.ladder):
        assert a.cost == b.cost
        assert math.isclose(a.error, b.error, rel_tol=1e-3)
    for site, prof in jplan.sensitivity.items():
        assert sorted(tplan.sensitivity[site]) == sorted(prof)
        for e, v in prof.items():
            assert math.isclose(tplan.sensitivity[site][e], v, rel_tol=1e-3)
    tm_, jm_ = dict(tplan.meta), dict(jplan.meta)
    tm_.pop("tune_seconds"), jm_.pop("tune_seconds")
    assert tm_ == jm_
    assert (tplan.arch, tplan.sites, tplan.block, tplan.mode) == \
        (jplan.arch, jplan.sites, jplan.block, jplan.mode)


def test_build_plan_lm_ladder_is_pareto_ordered():
    _, tplan, _ = _lm_plans()
    pts = tplan.ladder
    costs = [p.cost for p in pts]
    assert len(pts) >= 2 and costs == sorted(costs, reverse=True)
    assert [p.error for p in pts] == sorted(p.error for p in pts)
    for a, b in itertools.permutations(pts, 2):
        assert not (a.cost <= b.cost and a.error <= b.error
                    and (a.cost < b.cost or a.error < b.error))


def test_build_plan_greedy_matches_reference():
    """The measured-greedy strategy (forced by a zero exhaustive budget)
    walks the same vectors in both packages."""
    jm, jp, tm, tp = _lm_models()
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, jm.cfg.vocab, (2, 12)).astype(np.int32)}
    with P.jax_backend("pallas"):
        jplan = jtune.build_plan(jm, jp, batch, grid=(8, 5), exhaustive_budget=0)
    tplan = ttune.build_plan(tm, tp, batch, grid=(8, 5), exhaustive_budget=0)
    assert tplan.meta["strategy"] == jplan.meta["strategy"] == "greedy"
    assert tplan.meta["visited"] == jplan.meta["visited"]
    assert [p.degrees for p in tplan.ladder] == [p.degrees for p in jplan.ladder]
    for a, b in zip(tplan.ladder, jplan.ladder):
        assert a.cost == b.cost and math.isclose(a.error, b.error, rel_tol=1e-3)


def test_measure_error_exact_rung_of_exact_policy_is_zero():
    """An exact-policy model measures 0 error at any vector (the degree is
    ignored by EXACT specs), through the same prober code."""
    jm, jp, tm, tp = _lm_models()
    exact = tbuild_model(tm.cfg, device="cpu")
    batch = {"tokens": np.arange(8, dtype=np.int32)[None]}
    assert ttune.measure_error(exact, tp, batch, [5, 5, 5]) == 0.0


def test_build_plan_stream_equals_reference():
    ja, ta = jstream.StreamAdapter(), tstream.StreamAdapter(device="cpu")
    batch = {"frames": np.stack([tstream.make_clip(4, 256, seed=i) for i in range(3)])}
    jplan = jtune.build_plan(ja, ja.init_params(), batch, grid=GRID,
                             metric=jstream.psnr_metric)
    tplan = ttune.build_plan(ta, ta.init_params(), batch, grid=GRID,
                             metric=tstream.psnr_metric)
    jd, td = jplan.to_dict(), tplan.to_dict()
    assert td["meta"].pop("tune_seconds") >= 0
    jd["meta"].pop("tune_seconds")
    assert td == jd
    assert tplan.meta["metric"] == "neg_psnr_db" and tplan.meta["visited"] == 27
    assert tplan.ladder[0].degrees == (8, 8, 8)
    assert ta.exact_model() is ta


# ---------------------------------------------------------------------------
# serving a plan
# ---------------------------------------------------------------------------


def _serve_plan():
    """A plan with four distinct rungs for the prepacked f32 smoke engine."""
    _, tplan, _ = _lm_plans()
    idx = np.linspace(0, len(tplan.ladder) - 1, 4).round().astype(int)
    ladder = [tplan.ladder[i] for i in idx]
    return dataclasses.replace(tplan, ladder=ladder)


def _prompts(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, int(rng.integers(3, 9))).astype(np.int32)
            for _ in range(n)]


def _serve(eng, prompts, new_tokens):
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    eng.run_until_drained()
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("rung", range(4))
def test_engine_plan_rung_matches_manual_degree(rung):
    """Serving pinned at a plan rung == serving with that vector passed as
    the static degree (the plan is transport, not arithmetic), whether the
    rung is pinned by ``degree=`` or by a controller held on it; and the
    JAX engine under the same plan, pinned the same way, serves the same
    greedy streams (near-ties of the bf16 cache compared by margin, as in
    test_torch_serve.py)."""
    jm, jp, tm, tp = P.models("float32", "axq8")
    plan = _serve_plan()
    vec = plan.degrees(rung)
    prompts = _prompts(3)
    by_hand = _serve(TServeEngine(tm, tp, slots=2, max_len=32, degree=vec), prompts, 5)
    pinned = _serve(TServeEngine(tm, tp, slots=2, max_len=32, plan=plan, degree=vec),
                    prompts, 5)
    held = TQoS(ladder=[], low_water=-1.0, high_water=2.0, degree=rung)
    eng = TServeEngine(tm, tp, slots=2, max_len=32, plan=plan, qos=held)
    margins = P.record_margins(eng)
    treqs = [eng.submit(p, 5) for p in prompts]
    eng.run_until_drained()
    assert by_hand == pinned == [r.out_tokens for r in treqs]
    assert {d for _, d in eng.stats.degree_history} == {tuple(plan.ladder[rung].degrees)}
    jplan = jtune.ApproxPlan.from_dict(plan.to_dict())
    with P.jax_backend("xla"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, plan=jplan,
                            qos=JQoS(ladder=[], low_water=-1.0, high_water=2.0,
                                     degree=rung))
        jreqs = [jeng.submit(p, 5) for p in prompts]
        jeng.run_until_drained()
    P.compare_streams(jreqs, treqs, margins, 5, 1e-2)


def test_engine_plan_serves_like_reference_engine():
    """The port's engine and the JAX engine under the same plan and the
    same QoS controller: the same rung walk and the same greedy streams
    (near-ties of the bf16 cache compared by margin, as in
    test_torch_serve.py)."""
    jm, jp, tm, tp = P.models("float32", "axq8")
    plan = _serve_plan()
    jplan = jtune.ApproxPlan.from_dict(plan.to_dict())
    prompts = _prompts(5, seed=9)

    def qos(cls):
        return cls(ladder=[], low_water=0.25, high_water=0.75, cooldown_steps=1)

    with P.jax_backend("xla"):
        jeng = JServeEngine(jm, jp, slots=2, max_len=32, qos=qos(JQoS), plan=jplan)
        jreqs = [jeng.submit(p, 6) for p in prompts]
        jeng.run_until_drained()
    teng = TServeEngine(tm, tp, slots=2, max_len=32, qos=qos(TQoS), plan=plan)
    margins = P.record_margins(teng)
    treqs = [teng.submit(p, 6) for p in prompts]
    teng.run_until_drained()
    P.compare_streams(jreqs, treqs, margins, 6, 1e-2)
    assert [d for _, d in teng.stats.degree_history] == \
        [d for _, d in jeng.stats.degree_history]
    assert len({d for _, d in teng.stats.degree_history}) > 1


def test_engine_plan_without_qos_serves_rung_zero():
    _, _, tm, tp = P.models("float32", "axq8")
    plan = _serve_plan()
    eng = TServeEngine(tm, tp, slots=2, max_len=32, plan=plan)
    eng.submit(np.array([1, 2, 3]), 4)
    done = eng.run_until_drained()
    assert len(done) == 1 and len(done[0].out_tokens) == 4
    assert eng._degree.tolist() == list(plan.ladder[0].degrees)
    assert eng._degree.dtype == torch.int32


def test_engine_refuses_a_plan_of_another_arch():
    _, _, tm, tp = P.models("float32", "axq8")
    plan = ttune.uniform_plan(tget_config("qwen2.5-3b-smoke"))
    with pytest.raises(ValueError, match="tuned for"):
        TServeEngine(tm, tp, slots=2, max_len=32, plan=plan)


def test_qos_plan_ladder_steps_every_rung_with_no_new_call_shape():
    """Under sustained overload the controller walks the plan's ladder rung
    by rung (mirroring tests/test_tune.py's zero-recompile test): every
    rung's operand is built once at construction, a move swaps the
    reference, and the step meets one call shape."""
    _, _, tm, tp = P.models("float32", "axq8")
    plan = _serve_plan()
    qos = TQoS(ladder=[], low_water=0.25, high_water=0.75, cooldown_steps=1)
    eng = TServeEngine(tm, tp, slots=2, max_len=64, qos=qos, plan=plan)
    assert qos.ladder == plan.qos_ladder()
    rungs = list(eng._rungs)
    assert [r.tolist() for r in rungs] == [list(p.degrees) for p in plan.ladder]
    seen_ptrs = set()
    step = eng.workload.step

    def noting_step(params, state, feed, active, gen, degree):
        seen_ptrs.add(degree.data_ptr())
        return step(params, state, feed, active, gen, degree)

    eng.workload.step = noting_step
    for p in _prompts(12, seed=0):
        eng.submit(p, 8)
    assert len(eng.run_until_drained()) == 12
    visited = {d for _, d in eng.stats.degree_history}
    assert visited == {tuple(pt.degrees) for pt in plan.ladder}, visited
    assert eng.workload.trace_counts["step"] == 1
    # every degree the step read is one of the operands built at construction
    assert len(seen_ptrs) > 1 and seen_ptrs <= {r.data_ptr() for r in rungs}
    assert all(a is b for a, b in zip(eng._rungs, rungs))


def test_stream_engine_serves_a_stream_plan():
    ta = tstream.StreamAdapter(device="cpu")
    batch = {"frames": np.stack([tstream.make_clip(3, 256, seed=i) for i in range(2)])}
    plan = ttune.build_plan(ta, ta.init_params(), batch, grid=GRID,
                            metric=tstream.psnr_metric, max_rungs=4)
    clips = [tstream.make_clip(4, 256, seed=10 + i) for i in range(6)]
    qos = TQoS(ladder=[], low_water=0.25, high_water=0.75, cooldown_steps=1)
    eng = tstream.StreamServeEngine(ta, slots=2, qos=qos, plan=plan)
    reqs = [eng.submit(c) for c in clips]
    eng.run_until_drained()
    assert all(r.done and len(r.out) == 4 for r in reqs)
    visited = {d for _, d in eng.stats.degree_history}
    assert len(visited) > 1 and visited <= {tuple(p.degrees) for p in plan.ladder}
    # the same traffic on the JAX engine under the same plan: equal frames
    jeng = jstream.StreamServeEngine(
        jstream.StreamAdapter(), slots=2, plan=jtune.ApproxPlan.from_dict(plan.to_dict()),
        qos=JQoS(ladder=[], low_water=0.25, high_water=0.75, cooldown_steps=1))
    jreqs = [jeng.submit(c) for c in clips]
    jeng.run_until_drained()
    for r, q in zip(reqs, jreqs):
        for a, b in zip(r.out, q.out):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert [d for _, d in eng.stats.degree_history] == \
        [d for _, d in jeng.stats.degree_history]
