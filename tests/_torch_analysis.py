"""The steps the analysis tests count (``tests/test_torch_analysis.py``),
live on gloo ranks and on a meta mesh: one decode tick of the sharded
serving path (``serve_step`` and the vocab gather a sharded engine makes
of its logits) and one training step.  No JAX: the ranks run in processes
that ``meshctx.spawn_ranks`` starts."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core.approx import ApproxPolicy
from repro_torch.dist import collectives, meshctx, sharding
from repro_torch.dist.hlo_analysis import analyze_step
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models.layers import gather_vocab
from repro_torch.train import step as tstep

ARCH = "tinyllama-1.1b-smoke"
TIMEOUT_S = 120.0


def decode_tick(model, params, cache, tokens, tp):
    """The device work of one sharded decode tick: the step, then the
    logits' vocab columns gathered over ``model`` (``serve/lm.py``)."""
    logits, cache = tstep.serve_step(model, params, cache, tokens, tp=tp)
    return gather_vocab(logits), cache


def step_counts(shape, device: str, ring: bool = False, train: bool = False) -> dict:
    """{"bytes", "calls"} by kind of one decode tick (two slots, a cache of
    32) or one training step (4 x 16 global rows, remat full) of the f32
    smoke arch on a ``(data, model)`` mesh of ``shape``: counted live by
    ``collectives.counter`` on the gloo ranks (``device="cpu"``), or by the
    dry run on rank 0's meta mesh (``device="meta"``)."""
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    if device == "meta":
        mesh = meshctx.make_meta_mesh(shape, ("data", "model"))
    else:
        mesh = meshctx.make_mesh(shape, ("data", "model"), device=device)
    tp = mesh.size("model")
    with meshctx.use_mesh(mesh), kops.ring_tp(ring):
        model = build_model(cfg, ApproxPolicy(), device=device)
        if train:
            state = sharding.shard_train_state(tstep.init_state(model, tp=tp), mesh)
            rows = 4 // shape[0]
            batch = {k: torch.zeros((rows, 16), dtype=torch.int64, device=device)
                     for k in ("tokens", "labels")}
            fn, args = tstep.train_step, (model, tstep.StepConfig(remat="full"), state, batch)
        else:
            params = sharding.shard_params(model.init(seed=0, tp=tp), mesh=mesh)
            cache = model.init_cache(tp=tp, batch=2, max_len=32)
            tokens = torch.zeros((2, 1), dtype=torch.int64, device=device)
            fn, args = decode_tick, (model, params, cache, tokens)
        if device == "meta":
            rep = analyze_step(fn, *args, tp=tp)
            return {"bytes": {k: int(v) for k, v in rep.collectives.bytes_by_kind.items()},
                    "calls": dict(rep.collectives.calls_by_kind)}
        collectives.counter.reset()
        fn(*args, tp=tp)
        snap = collectives.counter.snapshot()
        return {"bytes": snap["bytes"], "calls": snap["calls"]}


def counts_rank(rank, world, jobs):
    """Each job's live counts on this rank."""
    return [step_counts(*job) for job in jobs]
