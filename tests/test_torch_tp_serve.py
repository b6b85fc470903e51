"""Tensor-parallel serving (``repro_torch.serve.sharded``) on the CPU:
tinyllama-1.1b-smoke in f32 as 2 (and, under EXACT, 4) spawned ranks of
one gloo group, each with its shards of the reference's tp-padded
parameters (``model.init(key, tp=tp)`` in JAX, through numpy and
``convert.shard_from_numpy``).

Held to: the greedy token streams of the port's one-process engine on the
same parameters, exactly, and through it those of the reference's
single-device ``ServeEngine(model, params, tp=tp)`` (as the reference's own
test holds its sharded engine to its single-device one) — equal under
EXACT; under AXQ equal up to a near-tie, a token whose top-2 logit margin
is below LOGIT_TOL = 1e-2 (tests/test_torch_serve.py's bound and reason:
the bf16 KV cache rounds the two packages' f32 keys and values an ulp
apart, and AXQ is chaotic in its inputs, ROADMAP §C), which ends that
request's comparison; the decode logits within 1e-5 of
the one-process step (the f32 partials are summed in another order); the
int8 ring's logits within the reference's envelope, rel < 0.05
(tests/test_sharded_serve.py); the ring's decode collective bytes at most
half the exact ones at tp=2; a QoS walk 8 -> 5 leaving every rank's
stream equal (the engine all-gathers and compares them at drain) and equal
to the one-process engine's; one tick's collectives as the model predicts.
AXQ runs at block 32, which divides the smoke's K shards (wo's 64 / 2)."""
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

ARCH = "tinyllama-1.1b-smoke"
PROMPTS = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 12, 13, 14], [300, 2, 77, 5, 9, 1]]
NEW = 8
LOGIT_TOL = 1e-2


def _jax_policy(name):
    if name == "exact":
        return None
    e, b = name[3:].split("/")
    return juniform(JSpec(mode=JMode.AXQ, ebits=int(e), block=int(b), dynamic=True))


def _reference(tp, policy):
    """(numpy params, the reference's single-device greedy streams)."""
    cfg = dataclasses.replace(jget_config(ARCH), dtype="float32")
    jm = jbuild_model(cfg, _jax_policy(policy))
    jp = jm.init(jax.random.PRNGKey(0), tp=tp)
    eng = JServeEngine(jm, jp, slots=2, max_len=32, tp=tp, degree=[8] * num_sites(cfg))
    reqs = [eng.submit(np.asarray(p, np.int32), NEW) for p in PROMPTS]
    eng.run_until_drained()
    return jax.tree.map(np.asarray, jp), [list(r.out_tokens) for r in reqs]


@pytest.mark.parametrize("tp,policy", [(2, "exact"), (4, "exact"), (2, "axq8/32")],
                         ids=["tp2-exact", "tp4-exact", "tp2-axq8-b32"])
def test_sharded_engine_matches_reference(tp, policy, tmp_path):
    tree, want = _reference(tp, policy)
    n = num_sites(jget_config(ARCH))
    exact = policy == "exact"
    opts = {"degree": [8] * n, "ring_logits": exact, "bytes": exact and tp == 2}
    got = meshctx.spawn_ranks(H.serve_rank, tp, store_dir=str(tmp_path), timeout_s=H.TIMEOUT_S,
                              args=(ARCH, policy, tree, PROMPTS, NEW, opts))
    r0 = got[0]
    assert r0["status"] == ["ok"] * len(PROMPTS)
    assert all(g["streams"] == r0["streams"] for g in got)
    assert r0["streams"] == r0["single_streams"]
    near_ties = []
    for rid, (a, b) in enumerate(zip(want, r0["single_streams"])):
        assert len(a) == len(b) == NEW
        for t, (x, y) in enumerate(zip(a, b)):
            if x != y:
                assert r0["single_margins"][(rid, t)] < LOGIT_TOL, (rid, t, x, y)
                near_ties.append((rid, t))
                break
    assert exact is False or not near_ties
    print(f"near-ties compared by logits instead of tokens: {near_ties}")
    np.testing.assert_allclose(r0["logits"], r0["single_logits"], rtol=0, atol=1e-5)
    for g in got:                              # gathered rows: equal on every rank
        assert np.array_equal(g["logits"], r0["logits"])
    if exact:
        ring, ex = r0["ring_logits"], r0["logits"]
        rel = np.abs(ring - ex).mean() / (np.abs(ex).mean() + 1e-9)
        assert 0 < rel < 0.05, rel
    if opts["bytes"]:
        exact_b, ring_b = r0["bytes"][False], r0["bytes"][True]
        assert exact_b["total"] > 0 and "collective-permute" not in exact_b
        assert ring_b["collective-permute"] > 0
        assert ring_b["total"] <= 0.5 * exact_b["total"], (ring_b, exact_b)


def test_qos_walk_keeps_the_ranks_in_step(tmp_path):
    """axq8 at block 32 with the ladder 8 -> 5 walked by load (six
    requests on two slots): every rank serves the same streams (checked at
    drain by the engine), the walk reaches 5, and streams and walk equal
    the one-process engine's."""
    tree, _ = _reference(2, "axq8/32")
    prompts = PROMPTS + [[5, 6, 7], [9, 9, 9, 9]]
    opts = {"ladder": (8, 7, 6, 5)}
    got = meshctx.spawn_ranks(H.serve_rank, 2, store_dir=str(tmp_path), timeout_s=H.TIMEOUT_S,
                              args=(ARCH, "axq8/32", tree, prompts, NEW, opts))
    r0 = got[0]
    assert r0["status"] == ["ok"] * len(prompts)
    assert got[1]["streams"] == r0["streams"] == r0["single_streams"]
    assert got[1]["degrees"] == r0["degrees"]
    assert (5,) in r0["degrees"] and (8,) in r0["degrees"]


def test_one_tick_runs_the_predicted_collectives(tmp_path):
    """One steady decode tick on 2 slots at tp=2: two all-reduces a layer
    (wo's and down's f32 partials) and the embedding's, of (2, d) f32
    each, and one all-gather of the logits' (2, V / 2) f32 shard."""
    cfg = jget_config(ARCH)
    tree, _ = _reference(2, "exact")
    got = meshctx.spawn_ranks(H.collective_counts_rank, 2, store_dir=str(tmp_path),
                              timeout_s=H.TIMEOUT_S, args=(ARCH, tree, 2))
    L, d, V = cfg.n_layers, cfg.d_model, cfg.padded(2).vocab
    for snap in got:
        assert snap["calls"] == {"all-reduce": 2 * L + 1, "all-gather": 1}
        assert snap["bytes"] == {"all-reduce": (2 * L + 1) * 2 * d * 4,
                                 "all-gather": 2 * (V // 2) * 4}
