"""The serving data axis (``repro_torch.serve.sharded``) on the CPU: one
engine's slots split over the data coordinates of a ``(D, M)`` mesh, as
gloo ranks spawned through ``meshctx.spawn_ranks``, each with its model
shards of the reference's tp-padded parameters (``model.init(key,
tp=M)`` in JAX, through numpy) and its slots' rows of the cache.

Held to, bit for bit (the reference's own test asserts its ``(2, 4)``
engine's greedy tokens bit-identical to one device's,
tests/test_sharded_serve.py): tinyllama-1.1b-smoke in f32 at 2x2 and 2x1
against the reference's one-device ``ServeEngine(tp=M)`` and the port's
one-process engine, with exact-length and bucketed, packed admission, on
the bf16 and the int8 cache; a QoS walk 8 -> 5 under axq8 (block 32) and
the int8 ring (every request ok) at 2x2; sampled streams (temperature 0.8,
top-k 8, one seed: the rows' logits are gathered before one generator
draws them) and the quality tap's samples; mamba2-370m-smoke at 2x1 on its
state cache (streams equal to the one-process engine's, each rank's
state rows within 1e-6 of its rows, bucketed == exact bit for bit); a
seeded seu_state / seu_param / nan / drop / spike storm with guards at 2x1
(recovery trace, injected faults, statuses and ok streams); one steady
tick's collectives at 2x2.  The MoE
family raises on a data axis, because the reference's own sharded engine
cannot serve it (a JAX subprocess on 8 host devices shows its failure;
ROADMAP §C)."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import _torch_dp as H
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.models.degrees import num_sites
from repro.serve.admission import AdmissionConfig as JAdm
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.dist import meshctx

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
DENSE = "tinyllama-1.1b-smoke"
SSM = "mamba2-370m-smoke"
MOE = "granite-moe-3b-a800m-smoke"
# six requests on four slots: slot reuse, a queue, prefixes past the
# largest bucket (8), which the packed pipeline admits at their length
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14], [300, 2, 77, 5, 9, 1, 4, 4, 4, 4],
           [5, 6, 7], [9, 9, 9, 9, 9, 9]]
NEW = 6
ADM = {"buckets": (4, 8), "pack": 2}
#: a rank's SSM state rows against the one-process engine's, relative to
#: the field's largest entry: the SSD einsums block a batch of 2 rows
#: otherwise than one of 4 (7.5e-09 of 0.356 seen; ROADMAP §C)
SSM_STATE_REL = 1e-6


def _tree(arch, tp):
    cfg = dataclasses.replace(jget_config(arch), dtype="float32")
    jm = jbuild_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0), tp=tp)
    return cfg, jm, jp, jax.tree.map(np.asarray, jp)


def _reference_streams(jm, jp, cfg, tp, *, adm, int8):
    """The reference's one-device greedy streams (f32 model, exact)."""
    prev = os.environ.get("REPRO_KV_INT8")
    os.environ["REPRO_KV_INT8"] = "1" if int8 else "0"
    try:
        eng = JServeEngine(jm, jp, slots=H.SLOTS, max_len=32, tp=tp,
                           degree=[8] * num_sites(cfg),
                           admission=JAdm(**adm) if adm else None)
        reqs = [eng.submit(np.asarray(p, np.int32), NEW) for p in PROMPTS]
        eng.run_until_drained()
    finally:
        if prev is None:
            os.environ.pop("REPRO_KV_INT8", None)
        else:
            os.environ["REPRO_KV_INT8"] = prev
    return [list(r.out_tokens) for r in reqs]


_MOE_REF = r"""
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.configs import get_config
from repro.dist import meshctx
from repro.models import build_model
from repro.serve.sharded import ShardedServeEngine
model = build_model(get_config("granite-moe-3b-a800m-smoke"))
out = {}
for shape in ((2, 1), (2, 2)):
    params = model.init(jax.random.PRNGKey(0), tp=shape[1])
    mesh = meshctx.make_mesh(shape, ("data", "model"))
    try:
        eng = ShardedServeEngine(model, params, mesh=mesh, slots=4, max_len=32)
        eng.submit([1, 2, 3, 4, 5], max_new_tokens=4)
        eng.run_until_drained()
        out[str(shape)] = "served"
    except Exception as e:
        out[str(shape)] = type(e).__name__ + ": " + str(e)[:400]
print("MOE_REF " + json.dumps(out))
"""


def _moe_reference():
    """The reference's own sharded engine on the MoE arch at 2x1 and 2x2
    (a subprocess: the host-device flag must precede the JAX import)."""
    return subprocess.Popen([sys.executable, "-c", _MOE_REF], cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                                 "HOME": os.environ.get("HOME", "/tmp"),
                                 "JAX_PLATFORMS": "cpu"})


def _assert_same(res, ref_streams=None):
    """Every rank's streams equal rank 0's and the one-process engine's
    (and the reference's when given); every request ok."""
    r0 = res[0]
    assert r0["status"] == ["ok"] * len(r0["streams"]), r0["status"]
    assert all(r["streams"] == r0["streams"] for r in res)
    assert r0["streams"] == r0["single"]["streams"]
    assert r0["status"] == r0["single"]["status"]
    if ref_streams is not None:
        assert r0["streams"] == ref_streams


def _assert_tap(res, rtol):
    """The quality tap's samples: the same on every rank (the global
    value), as many a rung as the one-process engine's and, with ``rtol``,
    their sum within it.  At tp = 2 the tap's AXQ logits rest on f32
    partials summed in another order, and its live-vs-exact difference
    moves with any int8 code they flip (ROADMAP §C), so the sums are held
    at 2x1 only."""
    taps = [r["tap"] for r in res]
    assert taps[0] and all(t == taps[0] for t in taps)
    one = res[0]["single"]["tap"]
    assert taps[0].keys() == one.keys()
    for k in one:
        assert taps[0][k][0] == one[k][0]
        if rtol is not None:
            np.testing.assert_allclose(taps[0][k][1], one[k][1], rtol=rtol, atol=0)


def _axq8_tree(cfg, tp):
    from repro.core.approx import ApproxMode, ApproxSpec, uniform

    jq = jbuild_model(cfg, uniform(ApproxSpec(mode=ApproxMode.AXQ, ebits=8, block=32,
                                              dynamic=True)))
    return jax.tree.map(np.asarray, jq.init(jax.random.PRNGKey(0), tp=tp))


def test_dense_2x2_matches_reference_and_one_process(tmp_path):
    """tinyllama-1.1b-smoke at 2x2, one spawn of four ranks: exact and
    packed admission on both caches (== the reference's one-device engine
    and the port's one-process engine, bit for bit), the axq8 QoS walk,
    the int8 ring, sampled streams with the quality tap, and one steady
    tick's collectives: each model group's (the embedding's and two a layer,
    the logits' all-gather over ``model``) plus the data axis's gather of
    the tokens, on the rank's two rows."""
    moe = _moe_reference()
    cfg, jm, jp, tree = _tree(DENSE, 2)
    qtree = _axq8_tree(cfg, 2)
    base = {"arch": DENSE, "tree": tree, "prompts": PROMPTS, "new": NEW}
    cases = [("exact_bf16", {}, None, False), ("packed_bf16", {"adm": ADM}, ADM, False),
             ("exact_int8", {"int8": True}, None, True),
             ("packed_int8", {"adm": ADM, "int8": True}, ADM, True)]
    jobs = [dict(base, **kw) for _, kw, _, _ in cases]
    jobs += [dict(base, tree=qtree, policy="axq8/32", ladder=(8, 7, 6, 5),
                  prompts=PROMPTS + [[4, 3, 2], [8, 8]]),
             dict(base, ring=True, single=False),
             dict(base, tree=qtree, policy="axq8/32", sample=11, tap=2, ladder=(8, 7, 6, 5)),
             dict(base, tick=True, single=False)]
    got = meshctx.spawn_ranks(H.serve_jobs_rank, 4, store_dir=str(tmp_path),
                              timeout_s=H.TIMEOUT_S, args=((2, 2), jobs))
    res = [[rank[i] for rank in got] for i in range(len(jobs))]
    for (name, _, adm, int8), r in zip(cases, res):
        want = _reference_streams(jm, jp, cfg, 2, adm=adm, int8=int8)
        _assert_same(r, want)
        assert r[0]["cache_type"] == ("LMCacheQ" if int8 else "LMCache"), name
        assert all(x["rows"] == 2 for x in r)            # S / D rows a rank
        if adm:
            assert r[0]["calls"]["prefill_batch"] == r[0]["single"]["calls"]["prefill_batch"]
    walk, ring, sampled, tick = res[4:]
    _assert_same(walk)
    assert all(r["degrees"] == walk[0]["degrees"] == walk[0]["single"]["degrees"]
               for r in walk)
    assert (5,) in walk[0]["degrees"] and (8,) in walk[0]["degrees"]
    assert ring[0]["status"] == ["ok"] * len(PROMPTS)
    assert all(r["streams"] == ring[0]["streams"] for r in ring)
    _assert_same(sampled)
    assert sampled[0]["streams"] != walk[0]["streams"][:len(PROMPTS)]
    _assert_tap(sampled, rtol=None)
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded(2).vocab
    for r in tick:
        assert r["tick"]["calls"] == {"all-reduce": 2 * L + 1, "all-gather": 2}
        assert r["tick"]["bytes"] == {"all-reduce": (2 * L + 1) * 2 * d * 4,
                                      "all-gather": 2 * (V // 2) * 4 + 2 * 4}
    out, err = moe.communicate(timeout=300)
    line = [ln for ln in out.splitlines() if ln.startswith("MOE_REF ")]
    assert line, err[-3000:]
    ref = json.loads(line[0][len("MOE_REF "):])
    for shape in ("(2, 1)", "(2, 2)"):
        assert "not evenly divisible" in ref[shape], ref


def test_data_axis_2x1_dense_ssm_faults_and_moe(tmp_path):
    """Two ranks at 2x1: tinyllama exact / packed on both caches (== the
    reference and the one-process engine), sampled axq8 streams with the
    quality tap (its sums within 1e-6 of the one-process engine's);
    mamba2-370m-smoke on its state cache, exact and bucketed (streams
    equal to the one-process engine's; each rank's state rows, the conv
    tail and SSD state, within SSM_STATE_REL of its, and bucketed == exact
    bit for bit); a seeded fault storm with guards (the one-process
    engine's recovery trace, injected faults, statuses and ok streams); the
    MoE arch raises with the reference's reason."""
    cfg, jm, jp, tree = _tree(DENSE, 1)
    scfg, _, _, stree = _tree(SSM, 1)
    base = {"arch": DENSE, "tree": tree, "prompts": PROMPTS, "new": NEW}
    cases = [({}, None, False), ({"adm": ADM, "int8": True}, ADM, True)]
    ssm = {"arch": SSM, "tree": stree, "prompts": PROMPTS, "new": NEW, "cache": True}
    storm = dict(base, faults="seu_state=0.3,seu_param=0.15,nan=0.3,drop=0.1,spike=0.1",
                 fault_seed=5)
    sampled = dict(base, tree=_axq8_tree(cfg, 1), policy="axq8/32", sample=11, tap=2,
                   ladder=(8, 7, 6, 5))
    jobs = [dict(base, **kw) for kw, _, _ in cases]
    jobs += [ssm, dict(ssm, adm={"buckets": (4, 8, 16), "pack": 2}), storm, sampled]
    got = meshctx.spawn_ranks(H.serve_jobs_rank, 2, store_dir=str(tmp_path),
                              timeout_s=H.TIMEOUT_S, args=((2, 1), jobs))
    res = [[rank[i] for rank in got] for i in range(len(jobs))]
    for (_, adm, int8), r in zip(cases, res):
        _assert_same(r, _reference_streams(jm, jp, cfg, 1, adm=adm, int8=int8))
    exact, bucketed, faults, sampled = res[2:]
    _assert_same(sampled)
    _assert_tap(sampled, rtol=1e-6)
    for r in (exact, bucketed):
        _assert_same(r)
        assert r[0]["cache_type"] == "SSMCache"
        one = r[0]["single"]["cache"]
        for rank in r:
            lo = rank["coord"]["data"] * 2
            for k, v in rank["cache"].items():
                want = one[k][lo:lo + 2] if k == "length" else one[k][:, lo:lo + 2]
                np.testing.assert_allclose(v, want, rtol=0, atol=SSM_STATE_REL * np.abs(want).max())
    for e, b in zip(exact, bucketed):                  # bucketed == exact, bit for bit
        for k, v in e["cache"].items():
            assert np.array_equal(v, b["cache"][k]), k
    assert exact[0]["streams"] == bucketed[0]["streams"]
    assert bucketed[0]["calls"]["prefill_batch"] > 0
    f0 = faults[0]
    assert f0["injected"] and any(k == "seu_state" for _, k, _ in f0["injected"])
    assert any(n == "guard_tripped" for _, n, _ in f0["resil_log"])
    for r in faults:
        for key in ("streams", "status", "resil_log", "injected"):
            assert r[key] == f0["single"][key], key
    msgs = meshctx.spawn_ranks(H.moe_refusal_rank, 2, store_dir=str(tmp_path),
                               timeout_s=H.TIMEOUT_S, args=((2, 1), MOE))
    assert all(m is not None and "cannot serve it" in m and "batch of 1" in m for m in msgs)


def test_launch_serve_mesh_2x2_on_gloo(capfd):
    """``launch.serve --mesh 2x2`` spawns four gloo ranks: every request
    ok, the ranks' streams equal, rank 0 prints the report; a data axis
    that does not divide ``--slots`` raises before any rank starts."""
    from repro_torch.launch import serve as launch_serve

    argv = ["--device", "cpu", "--dist-backend", "gloo", "--requests", "6",
            "--new-tokens", "4", "--slots", "4", "--mesh", "2x2"]
    s, eng = launch_serve.run(argv + ["--metrics"])
    assert eng is None and s["statuses"] == {"ok": 6} and s["streams_equal"]
    assert s["data"] == 2 and s["tp"] == 2
    assert s["collective_calls_per_tick"]["all-gather"] == 2.0
    out = capfd.readouterr().out
    assert out.count("[launch.serve] mesh 2x2 (gloo") == 1
    with pytest.raises(SystemExit, match="divide"):
        launch_serve.run(argv[:-4] + ["--slots", "3", "--mesh", "2x2"])
