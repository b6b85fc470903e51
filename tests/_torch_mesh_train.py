"""Shared setup and helpers of the ``test_torch_mesh_train*.py`` files (moved out
of ``tests/test_torch_mesh_train.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

Training on a mesh on the CPU: tinyllama-1.1b-smoke in f32 as spawned
gloo ranks (``tests/_torch_mesh.py``), each with its shards of the
reference's tp-padded state (``init_state(model, key, tp)`` in JAX, through
numpy and ``convert.train_state_from_numpy(mesh=...)``) and its rows of the
batch, held to the reference's jitted one-device ``train_step`` (AXQ on its
Pallas route in interpret mode, as tests/_torch_train.py runs it).

Compared after one step, with ``_torch_train``'s one-step bounds (RTOL
1e-5): loss and grad_norm rtol 1e-5, AdamW's mu / nu within 1e-5 of each
leaf's largest entry, every gathered updated parameter within rtol 1e-5 and
atol 1e-5 but for the entries whose (clipped) reference gradient is below
ILL_GRAD, held within Adam's step bound (2 lr) of the start on both sides,
as tests/test_torch_frontends.py holds them (ROADMAP §C: Adam's first step
moves an entry by lr x g / (|g| + eps), so where |g| is a few eps the f32
partials, summed in another order on the mesh, move it by a fraction of
lr), under EXACT and under AXQ at degree 8; the
replicated leaves bit-identical on every rank and the data ranks' states
bit-identical.  AXQ runs at block 32 (block 16 at 1x4, where wo's K shard
is 16 rows; block 32 raises there, as a shard that is not a whole number
of the global K's blocks must).  Also: a 2x1 batch whose ranks hold
different token counts, --compress-grads at 2x1 and 1x2, the int8-ring
lever (convergence at 2x2 as the reference's test_ring_tp_training_subprocess
asks; its gradients within rel 0.05 of the exact mesh step's), the
collectives of a step as the layer count predicts, the autograd
collectives' backward against a one-process autograd run.  The MoE family,
the frontends and the SSM and hybrid families train on a mesh in their own
files (tests/test_torch_mesh_moe.py, tests/test_torch_mesh_frontends.py,
tests/test_torch_mesh_recurrent.py).
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
from repro.core.approx import ApproxMode as JMode
from repro.core.approx import ApproxSpec as JSpec
from repro.core.approx import uniform as juniform
from repro.models import build_model as jbuild_model
from repro.train import step as jstep
from repro_torch.dist import meshctx
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

ARCH = H.ARCH
#: the smoke's two layers: forward (the embedding's and two a layer),
#: the loss (the max, the sum of exponentials, the target logit),
#: backward (two a layer and the head's), the gradient norm
L = 2
MODEL_ALL_REDUCES = (1 + 2 * L) + 3 + (2 * L + 1) + 1


def _jpolicy(name):
    if name == "exact":
        return None
    e, b = name[3:].split("/")
    return juniform(JSpec(mode=JMode.AXQ, ebits=int(e), block=int(b), dynamic=True))


def _batch(B=4, S=16, seed=0, mask_rows=None):
    toks = np.random.default_rng(seed).integers(0, 512, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    if mask_rows is not None:
        # unequal token counts over the data ranks: most of these rows masked
        batch["labels"][mask_rows, 3:] = -1
    return batch


_REFERENCES: dict = {}


def _reference(tp, policy, batch, *, compress=False, steps=1):
    """(global numpy state, [(numpy state, metrics)] after each step),
    computed once a module for each set of arguments."""
    key = (tp, policy, compress, steps, batch["labels"].tobytes())
    if key not in _REFERENCES:
        _REFERENCES[key] = _compute_reference(tp, policy, batch, compress, steps)
    return _REFERENCES[key]


def _compute_reference(tp, policy, batch, compress, steps):
    cfg = dataclasses.replace(jget_config(ARCH), dtype="float32")
    jm = jbuild_model(cfg, _jpolicy(policy))
    js = jstep.init_state(jm, jax.random.PRNGKey(0), tp=tp)
    scfg = jstep.StepConfig(remat="none", total_steps=10, warmup=2, compress_grads=compress)
    deg = None if policy == "exact" else jnp.int32(8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = []
    with TT.jax_backend("pallas"):
        f = jax.jit(lambda s, b, d: jstep.train_step(jm, scfg, s, b, tp=tp, degree=d))
        s = js
        for _ in range(steps):
            s, met = f(s, jb, deg)
            out.append((jax.tree.map(np.asarray, s), {k: float(v) for k, v in met.items()}))
    return jax.tree.map(np.asarray, js), out


#: a clipped gradient entry below this (1000 x AdamW's eps) is
#: ill-conditioned for a parity check of Adam's first update
#: (tests/test_torch_frontends.py's ILL_GRAD)
ILL_GRAD = 1e-5
B1, LR = 0.9, 3e-4


def _assert_matches(res, start, ref_state, ref_met, *, tol=TT.RTOL):
    """loss / grad_norm rtol ``tol``; the gathered parameters rtol and atol
    ``tol`` (the ill-conditioned entries within 2 lr of ``start`` on both
    sides), mu / nu within ``tol`` of each leaf's largest entry (as
    ``_torch_train.assert_states_close`` holds one step); returns the
    largest mu / nu difference relative to its leaf's largest entry."""
    met = res["metrics"][0]
    np.testing.assert_allclose(met["loss"], ref_met["loss"], rtol=tol)
    np.testing.assert_allclose(met["grad_norm"], ref_met["grad_norm"], rtol=tol)
    g = res["global"]
    for a, b, p0, mu in zip(tree_leaves(g.params),
                            *(jax.tree_util.tree_leaves(t) for t in
                              (ref_state.params, start.params, ref_state.opt.mu))):
        assert a.shape == b.shape, (a.shape, b.shape)
        ill = np.abs(mu) / (1 - B1) < ILL_GRAD
        np.testing.assert_allclose(a[~ill], b[~ill], rtol=tol, atol=tol)
        assert np.abs(a[ill] - p0[ill]).max(initial=0) <= 2 * LR
        assert np.abs(b[ill] - p0[ill]).max(initial=0) <= 2 * LR
    worst = 0.0
    for field in ("mu", "nu"):
        for a, b in zip(tree_leaves(getattr(g.opt, field)),
                        jax.tree_util.tree_leaves(getattr(ref_state.opt, field))):
            rel = TT.rel_to_max(a, b)
            worst = max(worst, rel)
            assert rel <= tol, (field, rel)
    assert int(g.step) == 1 and int(g.opt.step) == 1
    return worst


def _assert_rank_identity(ranks, shape):
    """Replicated leaves equal bit for bit on every rank; the data ranks of
    one model coordinate hold the same state bit for bit."""
    D, M = shape
    sharded = {n for n, v in ranks[0]["digest"].items()
               if any(r["digest"][n] != v for r in ranks[:M])}
    for r in ranks:
        for n, v in r["digest"].items():
            if n not in sharded:
                assert v == ranks[0]["digest"][n], n
    for m in range(M):
        for d in range(1, D):
            assert ranks[d * M + m]["digest"] == ranks[m]["digest"]
    return sharded


MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]
_RING_BATCH = np.random.default_rng(0).integers(0, 512, (4, 32)).astype(np.int32)


def _jobs(shape):
    """Every job of one spawn of ``shape``: (name, job, the reference's
    (start, state, metrics) or None)."""
    D, M = shape
    block = 16 if M == 4 else 32
    cases = [("exact", "exact", _batch(), {}), ("axq8", f"axq8/{block}", _batch(), {})]
    if shape == (2, 1):
        cases.append(("unequal", "exact", _batch(mask_rows=[0, 1]), {}))
    if D * M == 2:
        cases.append(("compress", "axq8/32", _batch(), {"compress": True}))
    out = []
    for name, policy, batch, extra in cases:
        state, ref = _reference(M, policy, batch, compress=bool(extra.get("compress")))
        out.append((name, {"policy": policy, "state": state, "batch": batch,
                           "degree": None if policy == "exact" else 8,
                           "grads": shape == (1, 2) and name == "exact", **extra},
                    (state, *ref[0])))
    state = out[0][1]["state"]
    if shape == (1, 2):
        out.append(("ring_grads", {"policy": "exact", "state": state, "batch": _batch(),
                                   "grads": True, "ring": True}, None))
    if shape == (2, 2):
        out.append(("ring_train", {"policy": "exact", "state": state, "ring": True,
                                   "batch": {"tokens": _RING_BATCH, "labels": _RING_BATCH},
                                   "steps": 25, "total": 40}, None))
    if shape == (1, 4):
        out.append(("axq8_block32", {"policy": "axq8/32", "state": state, "batch": _batch(),
                                     "degree": 8, "expect_raise": True}, None))
    return out


_RUNS: dict = {}


def _mesh_run(shape) -> dict:
    """{job name: (every rank's result, the reference or None)} of one
    spawn of ``shape``, run once a module."""
    if shape not in _RUNS:
        jobs = _jobs(shape)
        ranks = meshctx.spawn_ranks(H.step_rank, shape[0] * shape[1], timeout_s=H.TIMEOUT_S,
                                    args=(shape, [j for _, j, _ in jobs]))
        _RUNS[shape] = {name: ([r[i] for r in ranks], ref)
                        for i, (name, _, ref) in enumerate(jobs)}
    return _RUNS[shape]


def mesh_step_matches_reference(shape):
    """One step under EXACT and under axq8; the collectives of the EXACT
    step as the layer count predicts."""
    D, M = shape
    run = _mesh_run(shape)
    for name in ("exact", "axq8"):
        per, ref = run[name]
        _assert_matches(per[0], *ref)
        sharded = _assert_rank_identity(per, shape)
        assert ("params/layers/wq/w" in sharded) == (M > 1)
        assert all(r["metrics"][0]["loss"] == per[0]["metrics"][0]["loss"] for r in per)
    calls = run["exact"][0][0]["collectives"]["calls"]
    # the kv-split path (1x4): each gather's backward all-reduces
    want = (MODEL_ALL_REDUCES + (2 * L if M == 4 else 0)) if M > 1 else 0
    n_leaves = len(tree_leaves(run["exact"][1][0].params))
    if D > 1:
        want += 1 + n_leaves + 1          # ntokens, every gradient leaf, loss and ce
    assert calls.get("all-reduce", 0) == want, calls
    gathers = 2 * L if M == 4 else 0      # k and v a layer (the kv-split path)
    assert calls.get("all-gather", 0) == gathers, calls


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
    'JMode',
    'JSpec',
    'juniform',
    'jbuild_model',
    'jstep',
    'meshctx',
    'tree_leaves',
    'ARCH',
    'L',
    'MODEL_ALL_REDUCES',
    '_jpolicy',
    '_batch',
    '_REFERENCES',
    '_reference',
    '_compute_reference',
    'ILL_GRAD',
    'B1',
    'LR',
    '_assert_matches',
    '_assert_rank_identity',
    'MESHES',
    '_RING_BATCH',
    '_jobs',
    '_RUNS',
    '_mesh_run',
    'mesh_step_matches_reference',
]
