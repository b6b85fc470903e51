"""MoE training on a mesh on the CPU: granite-moe-3b-a800m-smoke in f32 as
spawned gloo ranks (``tests/_torch_mesh.py``), each with its shards of the
reference's tp-padded state (its experts over ``model``, the router
replicated) and its rows of the batch.

The yardstick depends on the data axis.  At 1x2 the reference's mesh
equals its own one-device step on the tp-padded state (loss 6.674776 vs
6.674778, aux 2.3335 on both, every gradient leaf within 1.2e-6 of its
largest entry), so the port is held to the reference's jitted one-device
``train_step``, as tests/test_torch_mesh_train.py holds dense.  At 2x1 and
2x2 it is not: the reference sizes capacity per data shard (``T_local``)
and averages each shard's aux loss over the data axis, which gives aux
2.659 against the one-device 2.334 and gradients 0.37-0.71 of their
largest entries away from the one-device ones; its mesh gradient is the
true gradient of its own mesh loss (central differences agree).  So there
the port is held to the reference's own mesh ``train_step``, run under
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` in one subprocess a
module, on its Pallas route (AXQ's kernels in interpret mode run under its
shard_map).

Bounds: tests/test_torch_mesh_train.py's one-step bounds (loss and grad
norm rtol 1e-5, mu / nu within 1e-5 of each leaf's largest entry, the
gathered parameters rtol / atol 1e-5 but for the entries whose clipped
reference gradient is below ILL_GRAD, held within 2 lr of the start on
both sides) under EXACT; under axq8 at degree 8 (AXQ block 32) the same
but for mu / nu, held within AXQ_FLOOR_MULT x the reference's own noise
floor (its Pallas and xla routes' distance, 2.6e-5 at 1x2: the expert
leaves' AXQ codes move with one-ulp activation differences, and the port's
one-device step sits 8.6e-5 from the reference there).  The replicated
leaves bit-identical on every rank and the data ranks' states
bit-identical.  Also: every gradient leaf at 1x2, the router's among them,
within 1e-5 of its largest entry against the reference's one-device
gradient; the int8-ring lever (the combine's straight-through backward):
its loss at the reference's ring loss, its gradient within RING_REL of the
exact mesh step's; the collectives of a step as the layer count predicts;
a 1x2 checkpoint restored at 1x1 and at 2x1 bit for bit."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh as H
import _torch_train as TT
from repro.configs import get_config as jget_config
from repro.models import build_model as jbuild_model
from repro.train import step as jstep
from repro_torch.dist import meshctx
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import named_leaves, tree_leaves
from test_torch_mesh_train import (ILL_GRAD, _assert_matches, _assert_rank_identity, _batch,
                                   _jpolicy)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-3b-a800m-smoke"
L = 2
#: model-axis all-reduces of one MoE step: forward the embedding's and two a
#: layer (wo's partials, the experts' combine), the loss's three, backward
#: three a layer (the attention input's dx, the dispatched rows' and the
#: gates' cotangents) and the head's, the gradient norm
MODEL_ALL_REDUCES = (1 + 2 * L) + 3 + (3 * L + 1) + 1
#: the ring lever's gradient against the exact mesh step's (Frobenius, each
#: leaf).  Not dense's 0.05: the ring's int8 combine moves the residual
#: stream enough to flip some tokens' top-k experts in the next layer, a
#: discrete change of the routing.  Measured 0.20-0.33 a leaf here; the
#: reference's own ring step sits 0.39-0.58 from its exact step (its
#: straight-through backward inside a check_vma=False shard_map also hands
#: the combine 1/tp of the cotangent, ROADMAP §C)
RING_REL = 0.5
#: the ring step's loss against the reference's (6.665847 vs 6.665811)
RING_LOSS_ATOL = 1e-4
#: axq8's mu / nu against the reference, in units of the reference's own
#: Pallas-vs-xla distance (AXQ's codes move with one-ulp differences of an
#: activation; the reference's two routes sit 2.6e-5 apart at 1x2), as 5i
#: holds axq8 on the card
AXQ_FLOOR_MULT = 4
B1, LR = 0.9, 3e-4
MESHES = [(1, 2), (2, 1), (2, 2)]
POLICIES = ("exact", "axq8/32")

_JAX_MESH = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.core.approx import ApproxMode, ApproxSpec, uniform
from repro.dist import meshctx
from repro.kernels import dispatch
from repro.models import build_model
from repro.train import step as jstep

arch, src, dst = sys.argv[1], sys.argv[2], sys.argv[3]
b = dict(np.load(src))
batch = {k: jnp.asarray(v) for k, v in b.items()}
out = {}
cfg = dataclasses.replace(get_config(arch), dtype="float32")
axq = uniform(ApproxSpec(mode=ApproxMode.AXQ, ebits=8, block=32, dynamic=True))
scfg = jstep.StepConfig(remat="none", total_steps=10, warmup=2)
for shape in ((2, 1), (2, 2)):
    for name, pol, backend in (("exact", None, "pallas"), ("axq8", axq, "pallas"),
                               ("axq8xla", axq, "xla")):
        dispatch.set_backend(backend)
        m = build_model(cfg, pol)
        meshctx.set_mesh(meshctx.make_mesh(shape, ("data", "model")))
        js = jstep.init_state(m, jax.random.PRNGKey(0), tp=shape[1])
        deg = None if pol is None else jnp.int32(8)
        f = jax.jit(lambda s, bb, d: jstep.train_step(m, scfg, s, bb, tp=shape[1], degree=d))
        s, met = f(js, batch, deg)
        key = f"{shape[0]}x{shape[1]}_{name}"
        for i, leaf in enumerate(jax.tree_util.tree_leaves(s)):
            out[f"{key}_leaf{i}"] = np.asarray(leaf)
        for k, v in met.items():
            out[f"{key}_met_{k}"] = np.asarray(v)
# the int8-ring lever at 1x2 (its loss; the forward's rings are the port's)
from repro.kernels import ops
from repro.models import moe
dispatch.set_backend("pallas")
moe._MOE_RING = True
m = build_model(cfg)
meshctx.set_mesh(meshctx.make_mesh((1, 2), ("data", "model")))
js = jstep.init_state(m, jax.random.PRNGKey(0), tp=2)
with ops.ring_tp(True):
    loss = jax.jit(lambda p: m.loss(p, batch, tp=2, remat="none")[0])(js.params)
out["ring_loss"] = np.asarray(loss)
np.savez(dst, **out)
print("JAX_MESH_OK")
"""


def _jmodel(policy):
    cfg = dataclasses.replace(jget_config(ARCH), dtype="float32")
    return jbuild_model(cfg, _jpolicy(policy))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{(shape, policy): (numpy start state, numpy state after one step,
    metrics)}: at 1x2 the reference's jitted one-device step on the tp-padded
    state (and ``grads``: its one-device gradient under EXACT); at 2x1 and
    2x2 its mesh step, from the subprocess."""
    d = tmp_path_factory.mktemp("jmesh")
    batch = _batch()
    np.savez(d / "batch.npz", **batch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", _JAX_MESH, ARCH, str(d / "batch.npz"),
                             str(d / "out.npz")], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    out = {}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    xla_axq = {}
    for policy, backend, compress in (("exact", "pallas", False), ("axq8/32", "pallas", False),
                                      ("axq8/32", "xla", False), ("exact", "pallas", True)):
        with TT.jax_backend(backend):
            jm = _jmodel(policy)
            js = jstep.init_state(jm, jax.random.PRNGKey(0), tp=2)
            deg = None if policy == "exact" else jnp.int32(8)
            cfg = jstep.StepConfig(remat="none", total_steps=10, warmup=2,
                                   compress_grads=compress)
            s, met = jax.jit(lambda s, b, g: jstep.train_step(jm, cfg, s, b, tp=2, degree=g))(
                js, jb, deg)
            if backend == "xla":
                xla_axq[(1, 2)] = jax.tree.map(np.asarray, s)
                continue
            out[((1, 2), "compress" if compress else policy)] = (
                jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, s),
                {k: float(v) for k, v in met.items()})
            if policy == "exact":
                g = jax.jit(jax.grad(lambda p: jm.loss(p, jb, tp=2, remat="none")[0]))(js.params)
                out["grads"] = jax.tree.map(np.asarray, g)
    stdout, stderr = proc.communicate(timeout=600)
    assert "JAX_MESH_OK" in stdout, stderr[-3000:]
    res = dict(np.load(d / "out.npz"))
    out["ring_loss"] = float(res["ring_loss"])

    def unpack(key, js):
        treedef = jax.tree_util.tree_structure(js)
        return jax.tree_util.tree_unflatten(
            treedef, [res[f"{key}_leaf{i}"] for i in range(treedef.num_leaves)])

    for shape in ((2, 1), (2, 2)):
        tag = f"{shape[0]}x{shape[1]}"
        for policy in POLICIES:
            js = jstep.init_state(_jmodel(policy), jax.random.PRNGKey(0), tp=shape[1])
            key = f"{tag}_{policy.split('/')[0]}"
            met = {k[len(key) + 5:]: float(v) for k, v in res.items()
                   if k.startswith(key + "_met_")}
            out[(shape, policy)] = (jax.tree.map(np.asarray, js), unpack(key, js), met)
        xla_axq[shape] = unpack(f"{tag}_axq8xla", js)
    for shape, other in xla_axq.items():
        # the reference's own noise floor under axq8: its Pallas and xla
        # routes' mu / nu, the largest distance over every leaf
        ref = out[(shape, "axq8/32")][1]
        out[("floor", shape)] = max(
            TT.rel_to_max(a, b) for f in ("mu", "nu") for a, b in
            zip(*(jax.tree_util.tree_leaves(getattr(t.opt, f)) for t in (ref, other))))
    return out


def _jobs(shape, reference):
    out = []
    for policy in POLICIES:
        start = reference[(shape, policy)][0]
        out.append((policy, {"arch": ARCH, "policy": policy, "state": start,
                             "batch": _batch(), "degree": None if policy == "exact" else 8,
                             "grads": shape == (1, 2) and policy == "exact"}))
    if shape == (1, 2):
        out.append(("ring", {"arch": ARCH, "policy": "exact", "batch": _batch(),
                             "state": reference[(shape, "exact")][0], "grads": True,
                             "ring": True}))
        out.append(("compress", {"arch": ARCH, "policy": "exact", "batch": _batch(),
                                 "state": reference[(shape, "exact")][0], "compress": True}))
    return out


_RUNS: dict = {}


@pytest.fixture(scope="module")
def runs(reference):
    """{shape: {job name: every rank's result}}, one spawn of ranks a mesh
    shape."""
    if not _RUNS:
        for shape in MESHES:
            jobs = _jobs(shape, reference)
            ranks = meshctx.spawn_ranks(H.step_rank, shape[0] * shape[1],
                                        timeout_s=H.TIMEOUT_S,
                                        args=(shape, [j for _, j in jobs]))
            _RUNS[shape] = {name: [r[i] for r in ranks] for i, (name, _) in enumerate(jobs)}
    return _RUNS


def _assert_matches_axq(res, start, ref_state, ref_met, floor):
    """``_assert_matches`` under axq8: loss, grad norm and the parameters
    (ILL_GRAD rule) at 1e-5, mu / nu within AXQ_FLOOR_MULT x ``floor`` (the
    reference's Pallas-vs-xla distance) of each leaf's largest entry."""
    met = res["metrics"][0]
    np.testing.assert_allclose(met["loss"], ref_met["loss"], rtol=TT.RTOL)
    np.testing.assert_allclose(met["grad_norm"], ref_met["grad_norm"], rtol=TT.RTOL)
    g = res["global"]
    for a, b, p0, mu in zip(tree_leaves(g.params),
                            *(jax.tree_util.tree_leaves(t) for t in
                              (ref_state.params, start.params, ref_state.opt.mu))):
        ill = np.abs(mu) / (1 - B1) < ILL_GRAD
        np.testing.assert_allclose(a[~ill], b[~ill], rtol=TT.RTOL, atol=TT.RTOL)
        assert np.abs(a[ill] - p0[ill]).max(initial=0) <= 2 * LR
        assert np.abs(b[ill] - p0[ill]).max(initial=0) <= 2 * LR
    tol = max(TT.RTOL, AXQ_FLOOR_MULT * floor)
    for field in ("mu", "nu"):
        for a, b in zip(tree_leaves(getattr(g.opt, field)),
                        jax.tree_util.tree_leaves(getattr(ref_state.opt, field))):
            assert TT.rel_to_max(a, b) <= tol, (field, TT.rel_to_max(a, b), floor)


@pytest.mark.parametrize("policy", POLICIES, ids=["exact", "axq8"])
@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_moe_mesh_step_matches_reference(shape, policy, reference, runs):
    """One step at 1x2 against the reference's one-device step, at 2x1 and
    2x2 against its mesh step (module docstring); replicated leaves and
    the data ranks bit-identical, the losses equal on every rank."""
    per = runs[shape][policy]
    if policy == "exact":
        _assert_matches(per[0], *reference[(shape, policy)])
    else:
        _assert_matches_axq(per[0], *reference[(shape, policy)], reference[("floor", shape)])
    sharded = _assert_rank_identity(per, shape)
    assert ("params/layers/moe/experts/up" in sharded) == (shape[1] > 1)
    assert "params/layers/moe/router/w" not in sharded
    assert all(r["metrics"][0]["loss"] == per[0]["metrics"][0]["loss"] for r in per)
    np.testing.assert_allclose(per[0]["metrics"][0]["aux"], reference[(shape, policy)][2]["aux"],
                               rtol=1e-5)


def test_data_axis_is_not_the_one_device_step(reference):
    """At 2x1 the reference's aux is the mean of its data shards' (capacity
    per shard), not the one-device aux: the readings the module docstring
    cites, and why 2x1 / 2x2 are held to the mesh step."""
    one, mesh = reference[((1, 2), "exact")][2], reference[((2, 1), "exact")][2]
    assert abs(one["aux"] - 2.3335) < 1e-3 and abs(mesh["aux"] - 2.6592) < 1e-3
    assert mesh["loss"] == reference[((2, 2), "exact")][2]["loss"]


def test_router_and_every_gradient_at_1x2(reference, runs):
    """The gathered gradients of one ``value_and_grad`` at 1x2 against the
    reference's one-device gradient: the router's (the gates of this
    rank's experts summed over ``model``, the aux counted once) and every
    other leaf within 1e-5 of its largest entry."""
    mine = dict(named_leaves(runs[(1, 2)]["exact"][0]["grads"]))
    want = dict(zip(mine, jax.tree_util.tree_leaves(reference["grads"])))
    for name in mine:
        assert TT.rel_to_max(mine[name], want[name]) <= 1e-5, name
    assert np.abs(mine["layers/moe/router/w"]).max() > 0


def test_compressed_grads_at_1x2(reference, runs):
    """--compress-grads at 1x2: the global gradient quantize-dequantized to
    int8 (an expert leaf against the whole leaf's amax, over its shards),
    against the reference's compressed one-device step.  A gradient summed
    in another order can round to the next int8 code, as on the card (5i):
    loss and grad norm rtol 1e-5, mu within one code (1/127 of the leaf's
    amax) plus 1e-5 of its largest entry, nu within two, the parameters
    within Adam's step bound, 2 lr."""
    res, (start, ref, met) = runs[(1, 2)]["compress"][0], reference[((1, 2), "compress")]
    np.testing.assert_allclose(res["metrics"][0]["loss"], met["loss"], rtol=TT.RTOL)
    np.testing.assert_allclose(res["metrics"][0]["grad_norm"], met["grad_norm"], rtol=TT.RTOL)
    g = res["global"]
    for a, b in zip(tree_leaves(g.params), jax.tree_util.tree_leaves(ref.params)):
        assert np.abs(a - b).max() <= 2 * LR
    for field, codes in (("mu", 1), ("nu", 2)):
        for a, b in zip(tree_leaves(getattr(g.opt, field)),
                        jax.tree_util.tree_leaves(getattr(ref.opt, field))):
            assert TT.rel_to_max(a, b) <= codes / 127 + TT.RTOL, field


def test_ring_lever_straight_through(reference, runs):
    """REPRO_RING_TP at 1x2: the combine (and the attention's reductions)
    through the int8 ring.  Its loss within RING_LOSS_ATOL of the
    reference's ring loss (the compiled ring is a fused multiply-add apart,
    ROADMAP §C); with the straight-through backward every gradient leaf
    within RING_REL (Frobenius) of the exact mesh step's, some moved, some
    ring bytes sent."""
    exact, ring = runs[(1, 2)]["exact"][0], runs[(1, 2)]["ring"][0]
    assert abs(ring["metrics"][0]["loss"] - reference["ring_loss"]) <= RING_LOSS_ATOL
    for a, b in zip(tree_leaves(ring["grads"]), tree_leaves(exact["grads"])):
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert rel < RING_REL, rel
    assert any(not np.array_equal(a, b) for a, b in
               zip(tree_leaves(ring["grads"]), tree_leaves(exact["grads"])))
    assert ring["grad_bytes"]["bytes"]["collective-permute"] > 0


@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_collectives_a_step(shape, runs):
    """All-reduces of the EXACT step: 5L + 6 on a model axis, and on a data
    axis the token count, every gradient leaf and the loss / ce / aux."""
    D, M = shape
    res = runs[shape]["exact"][0]
    want = MODEL_ALL_REDUCES if M > 1 else 0
    if D > 1:
        want += 1 + len(tree_leaves(res["local"].params)) + 1
    assert res["collectives"]["calls"] == {"all-reduce": want}


TOTAL = 2


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A 1x2 trainer run of TOTAL steps (its last checkpoint at TOTAL), then
    the same directory restored by a 2x1 trainer."""
    d = tmp_path_factory.mktemp("mesh_moe_ckpt")
    opts = dict(arch=ARCH, total=TOTAL, ckpt_dir=str(d))
    full = meshctx.spawn_ranks(H.trainer_rank, 2, timeout_s=H.TIMEOUT_S, args=((1, 2), opts))
    data = meshctx.spawn_ranks(H.trainer_rank, 2, timeout_s=H.TIMEOUT_S, args=((2, 1), opts))
    return d, full, data


def test_checkpoint_restores_at_1x1_and_2x1(ckpt):
    """The 1x2 run's checkpoint (its experts gathered, rank 0 writes)
    restores at 1x1 through the port's trainer and at 2x1 on both ranks,
    every leaf bit for bit equal to the 1x2 ranks' gathered state."""
    d, full, data = ckpt
    assert all(r["saved"] == [TOTAL] for r in full)
    gathered = tree_leaves(full[0]["global"])
    t = Trainer(H.model_for("exact", ARCH), tstep.StepConfig(remat="none"),
                TrainerConfig(total_steps=TOTAL, ckpt_dir=str(d)), pipeline=None)
    state, start = t.init_or_restore()
    assert start == TOTAL
    mine = [x.numpy() for x in tree_leaves(state)]
    assert len(mine) == len(gathered)
    for a, b in zip(mine, gathered):
        np.testing.assert_array_equal(a, b)
    assert all(r["final_step"] == TOTAL and r["steps"] == [] for r in data)
    assert data[0]["digest"] == data[1]["digest"]
    for a, b in zip(tree_leaves(data[0]["global"]), gathered):
        np.testing.assert_array_equal(a, b)
