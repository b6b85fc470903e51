"""Shared setup and helpers of the ``test_torch_mesh_recurrent*.py`` files (moved out
of ``tests/test_torch_mesh_recurrent.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

Training the recurrent families on a mesh on the CPU: mamba2-370m-smoke
and recurrentgemma-2b-smoke in f32 as spawned gloo ranks
(``tests/_torch_mesh.py``), each with its heads and channels of the
reference's tp-padded state (``init_state(model, key, tp=M)`` in JAX,
through numpy and ``convert.train_state_from_numpy(mesh=...)``) and its
rows of the batch, held to the reference's jitted one-device
``train_step`` on that state (AXQ on its Pallas route in interpret mode):
the reference has no mesh-specific function for these families (GSPMD
partitions their one-device function), so at every mesh shape the port is
held to it.

Compared after one step at 1x2, 2x1, 2x2 and 1x4.  Under EXACT with
tests/test_torch_mesh_train.py's bounds: loss and grad norm rtol 1e-5, mu
/ nu within 1e-5 of each leaf's largest entry, the parameters rtol and
atol 1e-5 but for Adam's ill-conditioned entries (ROADMAP §C).  Under axq8
at block 16 (which divides every row-parallel K shard at 1x4: out_proj's
32, wo's 16) by axq8's floor (chip_smoke.py 5i's rule, ROADMAP §C): the
loss rtol 1e-5, each mu / nu leaf (relative Frobenius) and the grad norm
within 4x the port's own noise floor plus 1e-3, the parameters within
Adam's step bound (2 lr).  The AXQ gradient reaches x and w only at each
block's amax, so the mesh's reordered f32 sums move it where the block's
largest entries nearly tie: the floor is the move of a one-process step
when every AXQ product's f32 output is perturbed by 1e-6 relative (up to
1e-3 of a leaf for mamba2-370m-smoke, 0.04-0.42 for recurrentgemma-2b-smoke).
The replicated leaves and the data ranks' states bit for bit.  Also: at 1x2 and 1x4 every gradient leaf, named one by one
(``in_proj``'s B / C columns, the conv, ``dt_bias`` / ``a_log`` / ``D``,
``gnorm``, ``lam``, the tied embedding among them), within 1e-5 of its
largest entry of the port's one-process gradients; the two new autograd
collectives' backward against a one-process autograd run; --compress-grads
at 1x2 (EXACT); the int8-ring lever (25 steps at 2x2 that lower the loss
by more than 0.5 on every rank alike, and at 1x2 each gradient leaf within
RING_REL of the exact mesh step's: the reference's own envelope with
room); a 1x2 trainer's checkpoint restored at 1x1 and at 2x1
bit for bit.
"""
import dataclasses

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
from repro_torch.tree import named_leaves, tree_leaves
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_mesh_train import _assert_matches, _assert_rank_identity, _batch, _jpolicy

torch.set_num_threads(2)

ARCHS = ["mamba2-370m-smoke", "recurrentgemma-2b-smoke"]
IDS = {"mamba2-370m-smoke": "mamba2", "recurrentgemma-2b-smoke": "recurrentgemma"}
MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
AXQ = "axq8/16"
TRAIN_STEPS = 2
_RING_BATCH = np.random.default_rng(0).integers(0, 512, (4, 32)).astype(np.int32)


def _ref_tp(arch, tp):
    """The tp of the reference step a mesh of ``tp`` model ranks is held
    to.  mamba2-370m-smoke has no heads to pad and a vocab (512) that 4
    divides: its tp-padded state and step are the same at tp 1, 2 and 4
    (test_reference_trees_are_tp_invariant), so one reference serves."""
    return 1 if arch.startswith("mamba2") else tp


_REFERENCES: dict = {}


def _reference(arch, tp, policy, compress=False):
    """(global numpy state, [(numpy state, metrics)]) of one reference
    step, computed once a module for each set of arguments."""
    key = (arch, _ref_tp(arch, tp), policy, compress)
    if key not in _REFERENCES:
        cfg = dataclasses.replace(jget_config(arch), dtype="float32")
        jm = jbuild_model(cfg, _jpolicy(policy))
        t = key[1]
        js = jstep.init_state(jm, jax.random.PRNGKey(0), tp=t)
        scfg = jstep.StepConfig(remat="none", total_steps=10, warmup=2,
                                compress_grads=compress)
        jb = {k: jnp.asarray(v) for k, v in _batch().items()}
        with TT.jax_backend("pallas"):
            s, met = jax.jit(lambda s, b, d: jstep.train_step(jm, scfg, s, b, tp=t, degree=d))(
                js, jb, None if policy == "exact" else jnp.int32(8))
        _REFERENCES[key] = (jax.tree.map(np.asarray, js),
                            [(jax.tree.map(np.asarray, s),
                              {k: float(v) for k, v in met.items()})])
    return _REFERENCES[key]


#: the axq8 floor rule (chip_smoke.py 5i's): each mu / nu leaf's relative
#: Frobenius distance from the reference within AXQ_FLOOR_MULT x the
#: port's own noise floor plus AXQ_FLOOR_SLACK, the grad norm the same, the
#: parameters within Adam's step bound (2 lr)
AXQ_FLOOR_MULT = 4.0
AXQ_FLOOR_SLACK = 1e-3
NOISE_EPS = 1e-6
_FLOORS: dict = {}


def _frob(a, b) -> float:
    na = float(np.linalg.norm((np.asarray(a, np.float64) - b).ravel()))
    return 0.0 if na == 0 else na / max(float(np.linalg.norm(np.asarray(b).ravel())), 1e-30)


def _axq_floor(arch, tp):
    """The port's own noise floor of one axq8 step on the reference's
    start state, one process: each mu / nu leaf's and the grad norm's
    relative distance between the step and the same step with every AXQ
    product's f32 output perturbed by NOISE_EPS relative (seeded noise:
    5b's measure, the size of the mesh's reordered f32 sums)."""
    from repro_torch.convert import train_state_from_numpy
    from repro_torch.kernels import dispatch as kd

    key = (arch, _ref_tp(arch, tp))
    if key in _FLOORS:
        return _FLOORS[key]
    start, _ = _reference(arch, tp, AXQ)
    model = H.model_for(AXQ, arch)
    scfg = tstep.StepConfig(remat="none", total_steps=10, warmup=2)
    deg = torch.tensor(8, dtype=torch.int32)
    gen = torch.Generator().manual_seed(7)

    def noisy(f):
        def call(*a, **kw):
            y = f(*a, **kw)
            return y * (1 + NOISE_EPS * torch.randn(y.shape, generator=gen))
        return call

    runs = []
    for perturb in (False, True):
        saved = kd.axq_matmul, kd.axq_gated
        if perturb:
            kd.axq_matmul, kd.axq_gated = noisy(kd.axq_matmul), noisy(kd.axq_gated)
        try:
            new, met = tstep.train_step(model, scfg, train_state_from_numpy(start),
                                        H.torch_batch(_batch()), tp=tp, degree=deg)
        finally:
            kd.axq_matmul, kd.axq_gated = saved
        runs.append((H.to_numpy(new), float(met["grad_norm"])))
    (a, ga), (b, gb) = runs
    _FLOORS[key] = {f: [_frob(x, y) for x, y in zip(tree_leaves(getattr(b.opt, f)),
                                                     tree_leaves(getattr(a.opt, f)))]
                    for f in ("mu", "nu")}
    _FLOORS[key]["grad_norm"] = abs(gb - ga) / ga
    return _FLOORS[key]


def _assert_matches_axq(res, start, ref_state, ref_met, floor):
    """The axq8 floor rule (AXQ_FLOOR_MULT above) against the reference;
    the loss rtol 1e-5."""
    met = res["metrics"][0]
    tol = lambda f: AXQ_FLOOR_MULT * f + AXQ_FLOOR_SLACK
    np.testing.assert_allclose(met["loss"], ref_met["loss"], rtol=TT.RTOL)
    assert abs(met["grad_norm"] - ref_met["grad_norm"]) / ref_met["grad_norm"] <= tol(
        floor["grad_norm"])
    g = res["global"]
    for a, b in zip(tree_leaves(g.params), jax.tree_util.tree_leaves(ref_state.params)):
        assert np.abs(a - b).max() <= 2 * 3e-4
    for field in ("mu", "nu"):
        for i, (a, b) in enumerate(zip(tree_leaves(getattr(g.opt, field)),
                                       jax.tree_util.tree_leaves(getattr(ref_state.opt,
                                                                         field)))):
            assert _frob(a, b) <= tol(floor[field][i]), (field, i, _frob(a, b),
                                                          floor[field][i])


def _jobs(shape):
    """(name, job, (start, state, metrics) or None) of one spawn."""
    D, M = shape
    out = []
    for arch in ARCHS:
        cases = [("exact", "exact", {}), ("axq8", AXQ, {})]
        if shape == (1, 2):
            cases.append(("compress", "exact", {"compress": True}))
        for name, policy, extra in cases:
            state, ref = _reference(arch, M, policy, compress=bool(extra.get("compress")))
            out.append(((arch, name), {"arch": arch, "policy": policy, "state": state,
                                       "batch": _batch(),
                                       "degree": None if policy == "exact" else 8,
                                       "grads": M > 1 and D == 1 and name == "exact",
                                       **extra},
                        (state, *ref[0])))
        state = out[-len(cases)][1]["state"]
        if shape == (1, 2):
            out.append(((arch, "ring_grads"), {"arch": arch, "policy": "exact", "state": state,
                                                "batch": _batch(), "grads": True,
                                                "ring": True}, None))
        if shape == (2, 2):
            out.append(((arch, "ring_train"), {"arch": arch, "policy": "exact", "state": state,
                                                "ring": True, "steps": 25, "total": 40,
                                                "batch": {"tokens": _RING_BATCH,
                                                          "labels": _RING_BATCH}}, None))
    return out


_RUNS: dict = {}


def _ckpt_dir(arch):
    return str(_RUNS["dir"] / IDS[arch])


def _mesh_run(shape) -> dict:
    """{(arch, job name): (every rank's result, the reference or None)},
    plus the rank results' extras, of one spawn of ``shape``, run once a
    module (2x1 after 1x2: it restores 1x2's checkpoints)."""
    if shape == (2, 1):
        _mesh_run((1, 2))
    if shape not in _RUNS:
        jobs = _jobs(shape)
        extra = {"one_rank_grads": shape in ((1, 2), (1, 4))}
        if shape in ((1, 2), (2, 1)):
            extra["trainers"] = {IDS[a]: {"arch": a, "total": TRAIN_STEPS,
                                          "ckpt_dir": _ckpt_dir(a)} for a in ARCHS}
        ranks = meshctx.spawn_ranks(H.recurrent_mesh_rank, shape[0] * shape[1],
                                    timeout_s=2 * H.TIMEOUT_S,
                                    args=(shape, [j for _, j, _ in jobs], extra))
        run = {name: ([r["steps"][i] for r in ranks], ref)
               for i, (name, _, ref) in enumerate(jobs)}
        run["extra"] = ranks
        _RUNS[shape] = run
    return _RUNS[shape]


@pytest.fixture(scope="module", autouse=True)
def _ckpt_root(tmp_path_factory):
    _RUNS["dir"] = tmp_path_factory.mktemp("mesh_recurrent")
    yield
    _RUNS.clear()


def mesh_step_matches_reference(shape, arch):
    """One step under EXACT and under axq8 against the reference's
    one-device step; the part-wise leaves split on every rank."""
    D, M = shape
    run = _mesh_run(shape)
    for name in ("exact", "axq8"):
        per, ref = run[(arch, name)]
        if name == "exact":
            _assert_matches(per[0], *ref)
        else:
            _assert_matches_axq(per[0], *ref, _axq_floor(arch, M))
        sharded = _assert_rank_identity(per, shape)
        key = "params/layers/in_proj/w" if arch.startswith("mamba2") else \
            "params/groups/rec0/lam"
        assert (key in sharded) == (M > 1)
        assert all(r["metrics"][0]["loss"] == per[0]["metrics"][0]["loss"] for r in per)


#: the ring's gradient bound a leaf (relative Frobenius): the reference's
#: own ring step sits 0.029 (mamba2-370m-smoke) and 0.078
#: (recurrentgemma-2b-smoke, rec1's lam) from its exact step at this size
#: (tools/ring_grad_ref.py --batch 4 --seq 16, ROADMAP §C)
RING_REL = {"mamba2-370m-smoke": 0.05, "recurrentgemma-2b-smoke": 0.1}


#: the gradient leaves named one by one (a tree path without ``params/``)
NAMED = {"mamba2-370m-smoke": ("layers/in_proj/w", "layers/conv/w", "layers/conv/b",
                               "layers/dt_bias", "layers/a_log", "layers/D",
                               "layers/gnorm/scale", "layers/out_proj/w", "embed/emb"),
         "recurrentgemma-2b-smoke": ("groups/rec0/lam", "groups/rec0/conv/w",
                                     "groups/rec0/conv/b", "groups/rec0/wx/w",
                                     "groups/rec1/wa/w", "groups/attn2/wk/w",
                                     "groups/attn2/wq/w", "unembed/w", "embed/emb")}


def every_gradient_leaf(shape, arch):
    """The gathered mesh gradients of one ``value_and_grad``, every leaf
    within 1e-5 of its largest entry of the one-process gradients, the
    part-wise leaves named: in_proj's B / C columns alone among them."""
    run = _mesh_run(shape)
    per, _ = run[(arch, "exact")]
    i = [k for k in run if k != "extra"].index((arch, "exact"))
    want = dict(named_leaves(run["extra"][0]["one_rank_grads"][i]))
    got = dict(named_leaves(per[0]["grads"]))
    assert set(got) == set(want)
    for name in got:
        assert TT.rel_to_max(got[name], want[name]) <= TT.RTOL, name
    for name in NAMED[arch]:
        assert name in got and np.abs(want[name]).max() > 0, name
    if arch.startswith("mamba2"):
        cfg = jget_config(arch)
        d_in = cfg.ssm.expand * cfg.d_model
        bc = slice(2 * d_in, 2 * d_in + 2 * cfg.ssm.d_state)
        g, w = got["layers/in_proj/w"][..., bc], want["layers/in_proj/w"][..., bc]
        assert TT.rel_to_max(g, w) <= TT.RTOL


__all__ = [
    'dataclasses',
    'jax',
    'jnp',
    'np',
    'pytest',
    'torch',
    'H',
    'TT',
    'jget_config',
    'jbuild_model',
    'jstep',
    'meshctx',
    'named_leaves',
    'tree_leaves',
    'tstep',
    'Trainer',
    'TrainerConfig',
    '_assert_matches',
    '_assert_rank_identity',
    '_batch',
    '_jpolicy',
    'ARCHS',
    'IDS',
    'MESHES',
    'AXQ',
    'TRAIN_STEPS',
    '_RING_BATCH',
    '_ref_tp',
    '_REFERENCES',
    '_reference',
    'AXQ_FLOOR_MULT',
    'AXQ_FLOOR_SLACK',
    'NOISE_EPS',
    '_FLOORS',
    '_frob',
    '_axq_floor',
    '_assert_matches_axq',
    '_jobs',
    '_RUNS',
    '_ckpt_dir',
    '_mesh_run',
    '_ckpt_root',
    'mesh_step_matches_reference',
    'RING_REL',
    'NAMED',
    'every_gradient_leaf',
]
