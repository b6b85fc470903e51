"""The VLM and audio frontends trained on a mesh on the CPU:
internvl2-1b-smoke (``v_proj``: fc1, gelu, fc2, its patch embeddings
prepended to the tokens) and hubert-xlarge-smoke (``a_proj``: fc1 and
sinusoidal positions, non-causal attention) in f32 as spawned gloo ranks
(``tests/_torch_mesh.py``), held to the reference's jitted one-device
``train_step`` on its tp-padded state, as tests/test_torch_mesh_train.py
holds dense: loss and grad norm rtol 1e-5, mu / nu within 1e-5 of each
leaf's largest entry, the gathered parameters rtol / atol 1e-5 but for the
entries whose clipped reference gradient is below ILL_GRAD (held within 2
lr of the start on both sides), under EXACT and under axq8 at degree 8
(AXQ block 32), at 1x2 and 2x1; the replicated leaves bit-identical on
every rank (the frontends' biases among them; their weights are
column-parallel and gathered whole before their product) and the data
ranks' states bit-identical.  Also the two new autograd collectives'
backward against a one-process autograd run."""
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
from test_torch_mesh_train import _assert_matches, _assert_rank_identity, _jpolicy

torch.set_num_threads(2)

ARCHS = ("internvl2-1b-smoke", "hubert-xlarge-smoke")
MESHES = [(1, 2), (2, 1)]
POLICIES = ("exact", "axq8/32")


def _batch(cfg, B=4, S=16, seed=0):
    """One numpy draw: the frontend's features, the VLM's tokens, labels
    with some ignored (-1) entries."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[:, ::5] = -1
    b = {"labels": labels}
    if cfg.frontend == "audio":
        b["frame_feats"] = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
    else:
        b["patch_embeds"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    return b


_REFERENCES: dict = {}


def _reference(arch, policy):
    """(numpy start state, numpy state after one step, metrics) of the
    reference's one-device step on the tp=2 state, once a module."""
    key = (arch, policy)
    if key not in _REFERENCES:
        cfg = dataclasses.replace(jget_config(arch), dtype="float32")
        jm = jbuild_model(cfg, _jpolicy(policy))
        js = jstep.init_state(jm, jax.random.PRNGKey(0), tp=2)
        scfg = jstep.StepConfig(remat="none", total_steps=10, warmup=2)
        jb = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
        deg = None if policy == "exact" else jnp.int32(8)
        with TT.jax_backend("pallas"):
            s, met = jax.jit(lambda s, b, d: jstep.train_step(jm, scfg, s, b, tp=2, degree=d))(
                js, jb, deg)
        _REFERENCES[key] = (jax.tree.map(np.asarray, js), jax.tree.map(np.asarray, s),
                            {k: float(v) for k, v in met.items()})
    return _REFERENCES[key]


_RUNS: dict = {}


def _mesh_run(shape) -> dict:
    """{(arch, policy): every rank's result} of one spawn of ``shape``."""
    if shape not in _RUNS:
        keys = [(a, p) for a in ARCHS for p in POLICIES]
        jobs = [{"arch": a, "policy": p, "state": _reference(a, p)[0],
                 "batch": _batch(jget_config(a)), "degree": None if p == "exact" else 8}
                for a, p in keys]
        ranks = meshctx.spawn_ranks(H.step_rank, shape[0] * shape[1], timeout_s=H.TIMEOUT_S,
                                    args=(shape, jobs))
        _RUNS[shape] = {k: [r[i] for r in ranks] for i, k in enumerate(keys)}
    return _RUNS[shape]


@pytest.mark.parametrize("policy", POLICIES, ids=["exact", "axq8"])
@pytest.mark.parametrize("arch", ARCHS, ids=["internvl2", "hubert"])
@pytest.mark.parametrize("shape", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
def test_frontend_mesh_step_matches_reference(shape, arch, policy):
    """One step against the reference's one-device step (module docstring);
    at 1x2 the frontend's weights sharded, its biases replicated."""
    per = _mesh_run(shape)[(arch, policy)]
    _assert_matches(per[0], *_reference(arch, policy))
    sharded = _assert_rank_identity(per, shape)
    fe = "v_proj" if arch.startswith("internvl") else "a_proj"
    assert (f"params/{fe}/fc1/w" in sharded) == (shape[1] > 1)
    assert f"params/{fe}/fc1/b" not in sharded
    assert all(r["metrics"][0]["loss"] == per[0]["metrics"][0]["loss"] for r in per)


def test_gather_and_ring_backward():
    """gather_from_model and ring_reduce_from_model on two ranks: each
    rank's gradient of its input equals the one-process autograd gradient
    of the replicated loss of the gathered tensor (its slice); the ring's
    backward is the cotangent unchanged."""
    world = 2
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(world)]
    ws = rng.standard_normal((3, 4 * world)).astype(np.float32)
    ranks = meshctx.spawn_ranks(H.gather_rank, world, timeout_s=H.TIMEOUT_S, args=(xs, ws))
    tx = [torch.from_numpy(x).requires_grad_() for x in xs]
    loss = (torch.tanh(torch.cat(tx, dim=-1)) * torch.from_numpy(ws)).sum()
    grads = torch.autograd.grad(loss, tx)
    for r in range(world):
        np.testing.assert_allclose(ranks[r]["gather"], grads[r].numpy(), rtol=1e-6)
        np.testing.assert_array_equal(ranks[r]["ring"], ws[:, :4])
