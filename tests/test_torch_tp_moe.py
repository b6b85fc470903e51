"""Expert parallelism (``repro_torch.models.moe`` on a mesh) on the CPU:
granite-moe-3b-a800m-smoke in f32 as 2 spawned gloo ranks, 4 of its 8
experts a rank, on the reference's tp-padded parameters (JAX
``model.init(key, tp=2)`` through numpy).

Held to: layer 0's MoE block with the exact combine (an f32 all-reduce of
the ranks' partial outputs) within 1e-5 of the one-process block (the
ranks' partials are summed in another order), the aux loss equal to the
one-process one on every rank (every rank routes the same tokens); the
int8-ring combine (``REPRO_RING_TP``) within the reference's envelope, rel
< 0.05, moving 2 (n-1) (chunk + 4) bytes; the sharded engine's greedy
streams equal to the one-process engine's, under EXACT and under AXQ at
block 32 (the expert-batched launches on each rank's 4 experts), and to the
reference's single-device engine's up to a near-tie
(tests/test_torch_tp_serve.py's rule)."""
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

torch.set_num_threads(2)

ARCH = "granite-moe-3b-a800m-smoke"
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14]]
NEW = 6
LOGIT_TOL = 1e-2


def _jax(policy):
    cfg = dataclasses.replace(jget_config(ARCH), dtype="float32")
    pol = None if policy == "exact" else juniform(
        JSpec(mode=JMode.AXQ, ebits=8, block=int(policy.split("/")[1]), dynamic=True))
    jm = jbuild_model(cfg, pol)
    return cfg, jm, jm.init(jax.random.PRNGKey(0), tp=2)


@pytest.mark.parametrize("policy", ["exact", "axq8/32"])
def test_expert_parallel_block_matches_one_process(policy, tmp_path):
    cfg, _, jp = _jax(policy)
    x = np.random.default_rng(5).standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    got = meshctx.spawn_ranks(H.moe_rank, 2, store_dir=str(tmp_path), timeout_s=H.TIMEOUT_S,
                              args=(ARCH, policy, jax.tree.map(np.asarray, jp), x))
    r0 = got[0]
    assert [g["E_local"] for g in got] == [cfg.moe.n_experts // 2] * 2
    for g in got:
        assert np.array_equal(g["y"], r0["y"])
        assert g["aux"] == r0["aux_single"]
    np.testing.assert_allclose(r0["y"], r0["y_single"], rtol=0, atol=1e-5)
    rel = np.abs(r0["y_ring"] - r0["y"]).mean() / np.abs(r0["y"]).mean()
    assert 0 < rel < 0.05, rel
    size = 2 * 7 * cfg.d_model
    assert r0["ring_bytes"] == {"collective-permute": 2 * (size // 2 + 4)}


@pytest.mark.parametrize("policy", ["exact", "axq8/32"])
def test_sharded_moe_engine_streams(policy, tmp_path):
    cfg, jm, jp = _jax(policy)
    eng = JServeEngine(jm, jp, slots=2, max_len=32, tp=2, degree=[8] * num_sites(cfg))
    jreqs = [eng.submit(np.asarray(p, np.int32), NEW) for p in PROMPTS]
    eng.run_until_drained()
    want = [list(r.out_tokens) for r in jreqs]
    opts = {"degree": [8] * num_sites(cfg)}
    got = meshctx.spawn_ranks(H.serve_rank, 2, store_dir=str(tmp_path), timeout_s=H.TIMEOUT_S,
                              args=(ARCH, policy, jax.tree.map(np.asarray, jp), PROMPTS, NEW,
                                    opts))
    r0 = got[0]
    assert r0["status"] == ["ok"] * len(PROMPTS)
    assert got[1]["streams"] == r0["streams"] == r0["single_streams"]
    np.testing.assert_allclose(r0["logits"], r0["single_logits"], rtol=0, atol=1e-5)
    for rid, (a, b) in enumerate(zip(want, r0["single_streams"])):
        for t, (u, v) in enumerate(zip(a, b)):
            if u != v:
                assert r0["single_margins"][(rid, t)] < LOGIT_TOL, (rid, t, u, v)
                break
