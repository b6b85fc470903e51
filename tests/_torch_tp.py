"""Rank functions of the tensor-parallel tests (``tests/test_torch_tp_*.py``).

They run in processes that ``repro_torch.dist.meshctx.spawn_ranks`` starts
(gloo on the CPU, one thread a rank), so they live in a module that
imports no JAX: each rank gets numpy parameter trees built by the JAX
reference in the test process, and returns numpy results.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, shard_from_numpy
from repro_torch.core.approx import ApproxMode, ApproxPolicy, ApproxSpec, uniform
from repro_torch.core.dynamic import QoSController
from repro_torch.dist import collectives, meshctx
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models.layers import gather_vocab
from repro_torch.serve.lm import ServeEngine
from repro_torch.serve.sharded import ShardedServeEngine, lm_decode_collective_bytes

TIMEOUT_S = 120.0


def policy_for(name: str) -> ApproxPolicy:
    """``exact``, or ``axqN/B``: AXQ at N bits with block B (dynamic)."""
    if name == "exact":
        return ApproxPolicy()
    e, b = name[3:].split("/")
    return uniform(ApproxSpec(mode=ApproxMode.AXQ, ebits=int(e), block=int(b),
                              dynamic=True))


def engine_opts(opts: dict) -> dict:
    """The engine keywords of ``opts``: a pinned ``degree``, or a QoS
    ``ladder`` of ebits (a fresh controller an engine)."""
    kw = {}
    if "degree" in opts:
        kw["degree"] = opts["degree"]
    if "ladder" in opts:
        kw["qos"] = QoSController(ladder=[{"ebits": e} for e in opts["ladder"]],
                                  low_water=0.25, high_water=0.75, cooldown_steps=1)
    return kw


def mesh_for(world: int) -> meshctx.Mesh:
    return meshctx.set_mesh(meshctx.make_mesh((1, world), ("data", "model")))


def decode_logits(model, params, tp: int, tokens: np.ndarray, prompt: np.ndarray,
                  ring: bool = False) -> np.ndarray:
    """Whole-row logits of one decode step after prefilling ``prompt``
    into every slot (f32 cache): the sharded step on the active mesh."""
    B = tokens.shape[0]
    cache = model.init_cache(tp=tp, batch=B, max_len=32, dtype=torch.float32, quant=False)
    with kops.ring_tp(ring):
        for s in range(B):
            model.prefill(params, cache, torch.from_numpy(prompt), s, tp=tp)
        logits, _ = model.decode_step(params, cache, torch.from_numpy(tokens), tp=tp)
    return gather_vocab(logits).numpy()


def record_margins(engine) -> dict:
    """{(rid, token index): the step's top-2 logit margin} of every token
    ``engine`` harvests (tests/_torch_parity.py's recorder, on the
    adapter's whole-row logits)."""
    margins: dict = {}
    last: dict = {}
    wl = engine.workload
    logits_fn, harvest = wl._logits, wl.harvest

    def logits_and_note(*a, **kw):
        logits, cache = logits_fn(*a, **kw)
        top2 = torch.topk(logits.float(), 2).values
        last["m"] = (top2[:, 0] - top2[:, 1]).tolist()
        return logits, cache

    def harvest_and_note(req, feed, slot, emission):
        margins[(req.rid, len(req.out))] = last["m"][slot]
        return harvest(req, feed, slot, emission)

    wl._logits, wl.harvest = logits_and_note, harvest_and_note
    return margins


def serve_rank(rank, world, arch, policy, tree, prompts, n_new, opts):
    """One rank of a sharded engine over ``tree`` (the global numpy
    params; the model in ``opts["dtype"]``, f32 by default): its streams, the decode logits of the exact and ring regimes,
    and the ring / exact decode bytes; rank 0 adds the one-process
    engine's streams and logits on the same parameters."""
    mesh = mesh_for(world)
    cfg = dataclasses.replace(get_config(arch), dtype=opts.get("dtype", "float32"))
    model = build_model(cfg, policy_for(policy), device="cpu")
    out = {}
    eng = ShardedServeEngine(model, params_from_numpy(tree), mesh=mesh, slots=2, max_len=32,
                             ring=opts.get("ring", False), **engine_opts(opts))
    reqs = [eng.submit(p, n_new) for p in prompts]
    eng.run_until_drained()
    out["streams"] = [list(r.out) for r in reqs]
    out["status"] = [r.status for r in reqs]
    out["degrees"] = [e for _, e in eng.stats.degree_history]
    toks = np.ones((2, 1), np.int64)
    prompt = np.asarray(prompts[0], np.int64)
    packed = eng.params
    out["logits"] = decode_logits(model, packed, world, toks, prompt)
    if opts.get("ring_logits"):
        out["ring_logits"] = decode_logits(model, packed, world, toks, prompt, ring=True)
    if opts.get("bytes"):
        out["bytes"] = {r: lm_decode_collective_bytes(arch, ring=r, policy=policy_for(policy))
                        for r in (False, True)}
    if rank == 0 and opts.get("single", True):
        with meshctx.use_mesh(meshctx.make_mesh((1, 1), ("data", "model"))):
            full = params_from_numpy(tree)
            ref = ServeEngine(model, full, slots=2, max_len=32, tp=world,
                              **engine_opts(opts))
            out["single_margins"] = record_margins(ref)
            rr = [ref.submit(p, n_new) for p in prompts]
            ref.run_until_drained()
            out["single_streams"] = [list(r.out) for r in rr]
            out["single_logits"] = decode_logits(model, ref.params, world, toks, prompt)
    return out


def collective_counts_rank(rank, world, arch, tree, n_slots):
    """Launch-independent counts of one eager tick of a sharded engine:
    the collectives by kind and their bytes."""
    mesh = mesh_for(world)
    model = build_model(dataclasses.replace(get_config(arch), dtype="float32"),
                        ApproxPolicy(), device="cpu")
    eng = ShardedServeEngine(model, params_from_numpy(tree), mesh=mesh, slots=n_slots,
                             max_len=32)
    for s in range(n_slots):
        eng.submit([1 + s, 2 + s, 3], 4)
    eng.tick()
    collectives.counter.reset()
    eng.tick()
    return collectives.counter.snapshot()


def ring_rank(rank, world, cases):
    """Each case's ``ring_allreduce_int8`` of this rank's slice (returned
    as f32) and the bytes the rank counted for it."""
    mesh = mesh_for(world)
    g = mesh.group("model")
    out = {}
    for key, (x, dtype) in cases.items():
        collectives.counter.reset()
        t = torch.from_numpy(x[rank]).to(getattr(torch, dtype))
        y = collectives.ring_allreduce_int8(t, g)
        assert y.dtype == t.dtype and y.shape == t.shape
        out[key] = (y.to(torch.float32).numpy(), collectives.counter.snapshot())
    return out


def collectives_rank(rank, world):
    """The exact wrappers, the shared broadcast, and the mesh's refusals
    inside a live group."""
    import pytest

    mesh = mesh_for(world)
    g = mesh.group("model")
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) * (rank + 1)
    s = collectives.all_reduce(x, g)
    a = collectives.all_gather(x, g, dim=-1)
    t = collectives.broadcast_value(float(rank + 10), g, mesh.device)
    with pytest.raises(ValueError, match="needs 4 ranks, the process group has 2"):
        meshctx.make_mesh((1, 4), ("data", "model"))
    return s.numpy(), a.numpy(), t, mesh.transport


def failing_rank(rank, world):
    if rank == 1:
        raise RuntimeError("rank one fails on purpose")
    return rank


def hanging_rank(rank, world):
    import time

    if rank == 1:
        time.sleep(60)
    return rank


def moe_rank(rank, world, arch, policy, tree, x):
    """Layer 0's MoE block on this rank's experts over ``x`` (B, S, d):
    the exact combine and the ring combine (f32 model), with the aux loss;
    rank 0 adds the one-process block on the whole tree."""
    from repro_torch.models import moe as tmoe
    from repro_torch.models.transformer import layer_params

    mesh = mesh_for(world)
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    model = build_model(cfg, policy_for(policy), device="cpu")
    local = model.prepack(shard_from_numpy(tree, mesh))
    xt = torch.from_numpy(x)
    lp = layer_params(local["layers"], 0)["moe"]
    out = {"E_local": int(local["layers"]["moe"]["experts"]["up"].shape[1])
           if isinstance(local["layers"]["moe"]["experts"]["up"], torch.Tensor)
           else int(local["layers"]["moe"]["experts"]["up"].qw.shape[1])}
    y, aux = tmoe.moe_apply(lp, xt, cfg, model.policy, "layer/moe")
    out["y"], out["aux"] = y.numpy(), float(aux)
    prev = tmoe._MOE_RING
    tmoe._MOE_RING = True
    try:
        collectives.counter.reset()
        yr, _ = tmoe.moe_apply(lp, xt, cfg, model.policy, "layer/moe")
        out["ring_bytes"] = collectives.counter.snapshot()["bytes"]
    finally:
        tmoe._MOE_RING = prev
    out["y_ring"] = yr.numpy()
    if rank == 0:
        with meshctx.use_mesh(meshctx.make_mesh((1, 1), ("data", "model"))):
            full = model.prepack(params_from_numpy(tree))
            y1, aux1 = tmoe.moe_apply(layer_params(full["layers"], 0)["moe"], xt, cfg,
                                      model.policy, "layer/moe")
        out["y_single"], out["aux_single"] = y1.numpy(), float(aux1)
    return out


def _state_fields(cache) -> dict:
    """The per-slot fields of a cache (every field but ``length``)."""
    return {k: getattr(cache, k) for k in cache._fields if k != "length"}


def bucketed_state_equal(model, params, tp: int, prompts, bucket: int) -> dict:
    """{field: max |difference|}: this rank's state of a bucketed, packed
    prefill of ``prompts`` (one call, rows padded to ``bucket``) against
    the same prompts prefilled one by one at their exact lengths (f32
    cache); the lengths too."""
    B = len(prompts)
    rows = np.zeros((B, bucket), np.int64)
    for i, p in enumerate(prompts):
        rows[i, :len(p)] = p
    lengths = [len(p) for p in prompts]
    exact = model.init_cache(tp=tp, batch=B, max_len=32, dtype=torch.float32, quant=False)
    packed = model.init_cache(tp=tp, batch=B, max_len=32, dtype=torch.float32, quant=False)
    for s, p in enumerate(prompts):
        model.prefill(params, exact, torch.as_tensor(np.asarray(p, np.int64)), s, tp=tp)
    model.prefill_batch(params, packed, torch.from_numpy(rows), list(range(B)), lengths, tp=tp)
    out = {k: float((v.float() - _state_fields(packed)[k].float()).abs().max())
           for k, v in _state_fields(exact).items()}
    out["length"] = float((exact.length - packed.length).abs().max())
    return out


def recurrent_serve_rank(rank, world, jobs):
    """Each job of ``jobs`` on one rank of a sharded engine over
    ``job["tree"]`` (the global numpy params, the model in f32): the
    streams of the plain engine and of bucketed, packed admission
    (``job["buckets"]``, pack 2), the whole-row decode logits (exact and,
    with ``ring``, under the int8 ring, with the ring step's collectives),
    the collectives of one steady decode tick on 2 slots, the bucketed
    prefill's state against exact-length prefills; rank 0 adds the
    one-process engine's streams, margins and logits."""
    from repro_torch.serve.admission import AdmissionConfig

    mesh = mesh_for(world)
    out = []
    for job in jobs:
        cfg = dataclasses.replace(get_config(job["arch"]), dtype="float32")
        model = build_model(cfg, policy_for(job["policy"]), device="cpu")
        kw = engine_opts(job)
        prompts, n_new = job["prompts"], job["new"]
        res = {}
        eng = ShardedServeEngine(model, params_from_numpy(job["tree"]), mesh=mesh, slots=2,
                                 max_len=32, **kw)
        reqs = [eng.submit(p, n_new) for p in prompts]
        eng.run_until_drained()
        res["streams"] = [list(r.out) for r in reqs]
        res["status"] = [r.status for r in reqs]
        adm = AdmissionConfig(buckets=tuple(job["buckets"]), pack=2)
        beng = ShardedServeEngine(model, params_from_numpy(job["tree"]), mesh=mesh, slots=2,
                                  max_len=32, admission=adm, **kw)
        breqs = [beng.submit(p, n_new) for p in prompts]
        beng.run_until_drained()
        res["bucketed_streams"] = [list(r.out) for r in breqs]
        res["bucketed_calls"] = beng.workload.trace_counts["prefill_batch"]
        packed = eng.params
        toks = np.ones((2, 1), np.int64)
        prompt = np.asarray(prompts[0], np.int64)
        res["logits"] = decode_logits(model, packed, world, toks, prompt)
        res["state_equal"] = bucketed_state_equal(model, packed, world, prompts[:3],
                                                  job["buckets"][-1])
        if job.get("ring"):
            res["ring_logits"] = decode_logits(model, packed, world, toks, prompt, ring=True)
        if job.get("counts"):
            ceng = ShardedServeEngine(model, params_from_numpy(job["tree"]), mesh=mesh,
                                      slots=2, max_len=32)
            for s in range(2):
                ceng.submit([1 + s, 2 + s, 3], 4)
            ceng.tick()
            collectives.counter.reset()
            ceng.tick()
            res["tick"] = collectives.counter.snapshot()
            with kops.ring_tp(True):
                collectives.counter.reset()
                ceng.tick()
            res["ring_tick"] = collectives.counter.snapshot()
        if rank == 0:
            with meshctx.use_mesh(meshctx.make_mesh((1, 1), ("data", "model"))):
                ref = ServeEngine(model, params_from_numpy(job["tree"]), slots=2, max_len=32,
                                  tp=world, **kw)
                res["single_margins"] = record_margins(ref)
                rr = [ref.submit(p, n_new) for p in prompts]
                ref.run_until_drained()
                res["single_streams"] = [list(r.out) for r in rr]
                res["single_logits"] = decode_logits(model, ref.params, world, toks, prompt)
        out.append(res)
    return out
