"""Shared setup and helpers of the ``test_torch_tp_recurrent*.py`` files (moved out
of ``tests/test_torch_tp_recurrent.py`` so that its tests spread over several
files, which ``pytest -n --dist loadfile`` runs on several workers).

Tensor-parallel serving of the recurrent families on the CPU:
mamba2-370m-smoke (8 SSD heads) and recurrentgemma-2b-smoke (4 query
heads over 1 kv head: MQA) in f32 as 2 (and, under EXACT, 4) spawned gloo
ranks, each with its heads and channels of the reference's tp-padded
parameters (``model.init(key, tp=tp)`` in JAX, through numpy): a Mamba-2
rank holds ``in_proj``'s ``[z_r | x_r | B | C | dt_r]``, an RG-LRU rank its
channels, an attention rank its query heads and, through the kv-split
path, its repeated kv head.

Held to: the greedy streams of the port's one-process engine on the same
parameters, exactly, with and without bucketed, packed admission; through
it the reference's single-device ``ServeEngine(model, params, tp=tp)``'s,
equal under EXACT and under AXQ up to a near-tie (a token whose top-2
margin is below LOGIT_TOL = 1e-2 ends that request's comparison:
tests/test_torch_tp_serve.py's rule); the decode logits within 1e-5 of the
one-process step; each rank's state after one bucketed, packed prefill
equal bit for bit to exact-length prefills at tp=2 (within 1e-6 at tp=4,
where gloo's ring all-reduce sums four ranks' partials in an order that
depends on the tensor's length, ROADMAP §C); the int8 ring's logits within
rel 0.05 of the exact ones, with ``gnorm``'s sum of squares still an exact
all-reduce under it; one steady decode tick's collectives as the layer
counts predict; ``launch.serve --tp 2`` on mamba2-370m-smoke to the end.
AXQ runs at block 16, which divides every row-parallel K shard (out_proj's
128 / 2, wo's 64 / 2, down's 128 / 2).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_tp as H
from repro.configs import get_config as jget_config
from repro.core.approx import ApproxMode as JMode
from repro.core.approx import ApproxSpec as JSpec
from repro.core.approx import uniform as juniform
from repro.models import build_model as jbuild_model
from repro.models.degrees import num_sites
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.dist import meshctx
from repro_torch.launch import serve as launch_serve

torch.set_num_threads(2)

ARCHS = ["mamba2-370m-smoke", "recurrentgemma-2b-smoke"]
# a prompt past mamba's chunk of 16 and the buckets' first rung
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [300, 2, 77, 5, 9, 1, 4, 4, 8, 13, 2, 90, 17, 3, 5, 6,
                                        11, 12, 40, 41], [11, 12, 13, 14]]
BUCKETS = (8, 16, 32)
NEW = 6
LOGIT_TOL = 1e-2
CASES = [(2, "exact"), (2, "axq8/16"), (4, "exact")]


def _jax_policy(name):
    if name == "exact":
        return None
    e, b = name[3:].split("/")
    return juniform(JSpec(mode=JMode.AXQ, ebits=int(e), block=int(b), dynamic=True))


def _reference(arch, tp, policy):
    """(numpy params, the reference's single-device greedy streams)."""
    cfg = dataclasses.replace(jget_config(arch), dtype="float32")
    jm = jbuild_model(cfg, _jax_policy(policy))
    jp = jm.init(jax.random.PRNGKey(0), tp=tp)
    eng = JServeEngine(jm, jp, slots=2, max_len=32, tp=tp, degree=[8] * num_sites(cfg))
    reqs = [eng.submit(np.asarray(p, np.int32), NEW) for p in PROMPTS]
    eng.run_until_drained()
    return jax.tree.map(np.asarray, jp), [list(r.out_tokens) for r in reqs]


_RUNS: dict = {}


def _run(tp) -> dict:
    """{(arch, policy): (every rank's result, the reference's streams)} of
    one spawn of ``tp`` ranks, run once a module."""
    if tp not in _RUNS:
        cases = [(a, p) for a in ARCHS for t, p in CASES if t == tp]
        jobs, refs = [], []
        for arch, policy in cases:
            tree, want = _reference(arch, tp, policy)
            refs.append(want)
            jobs.append({"arch": arch, "policy": policy, "tree": tree, "prompts": PROMPTS,
                         "new": NEW, "buckets": BUCKETS, "degree": [8] * num_sites(
                             jget_config(arch)), "ring": policy == "exact",
                         "counts": policy == "exact" and tp == 2})
        ranks = meshctx.spawn_ranks(H.recurrent_serve_rank, tp, timeout_s=H.TIMEOUT_S,
                                    args=(jobs,))
        _RUNS[tp] = {c: ([r[i] for r in ranks], refs[i]) for i, c in enumerate(cases)}
    return _RUNS[tp]


def sharded_recurrent_engine_matches_reference(arch, tp, policy):
    got, want = _run(tp)[(arch, policy)]
    r0 = got[0]
    assert r0["status"] == ["ok"] * len(PROMPTS)
    assert all(g["streams"] == r0["streams"] for g in got)
    assert r0["streams"] == r0["single_streams"] == r0["bucketed_streams"]
    assert r0["bucketed_calls"] > 0
    near_ties = []
    for rid, (a, b) in enumerate(zip(want, r0["single_streams"])):
        assert len(a) == len(b) == NEW
        for t, (x, y) in enumerate(zip(a, b)):
            if x != y:
                assert r0["single_margins"][(rid, t)] < LOGIT_TOL, (rid, t, x, y)
                near_ties.append((rid, t))
                break
    assert policy != "exact" or not near_ties
    print(f"near-ties compared by logits instead of tokens: {near_ties}")
    np.testing.assert_allclose(r0["logits"], r0["single_logits"], rtol=0, atol=1e-5)
    # two ranks' partials sum alike in any order; gloo's ring sums four in
    # an order that follows the tensor's length (ROADMAP §C)
    tol = 0.0 if tp == 2 else 1e-6
    for g in got:
        assert np.array_equal(g["logits"], r0["logits"])
        assert max(g["state_equal"].values()) <= tol, g["state_equal"]


__all__ = [
    'dataclasses',
    'jax',
    'np',
    'pytest',
    'torch',
    'H',
    'jget_config',
    'JMode',
    'JSpec',
    'juniform',
    'jbuild_model',
    'num_sites',
    'JServeEngine',
    'meshctx',
    'launch_serve',
    'ARCHS',
    'PROMPTS',
    'BUCKETS',
    'NEW',
    'LOGIT_TOL',
    'CASES',
    '_jax_policy',
    '_reference',
    '_RUNS',
    '_run',
    'sharded_recurrent_engine_matches_reference',
]
