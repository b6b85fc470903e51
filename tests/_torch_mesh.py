"""Rank functions of the mesh-training tests (``tests/test_torch_mesh_*.py``).

They run in processes that ``repro_torch.dist.meshctx.spawn_ranks`` starts
(gloo on the CPU, one thread a rank), so this module imports no JAX: the
ranks get numpy training states and batches built by the reference in the
test process, and return numpy results.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import signal

import numpy as np
import torch

from _torch_tp import policy_for
from repro_torch.configs import get_config
from repro_torch.convert import train_state_from_numpy
from repro_torch.core.dynamic import QoSController
from repro_torch.data.pipeline import make_pipeline
from repro_torch.dist import collectives, meshctx, sharding
from repro_torch.kernels import ops as kops
from repro_torch.models import build_model
from repro_torch.models import moe as moe_mod
from repro_torch.tree import named_leaves, tree_map
from repro_torch.train import step as tstep
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCH = "tinyllama-1.1b-smoke"
TIMEOUT_S = 120.0


def mesh_for(shape) -> meshctx.Mesh:
    return meshctx.set_mesh(meshctx.make_mesh(tuple(shape), ("data", "model")))


def model_for(policy: str, arch: str = ARCH):
    cfg = dataclasses.replace(get_config(arch), dtype="float32")
    return build_model(cfg, policy_for(policy), device="cpu")


def to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def digest(tree) -> dict:
    """{path: sha1 of the leaf's bytes}."""
    return {n: hashlib.sha1(np.ascontiguousarray(v.detach().numpy()).tobytes()).hexdigest()
            for n, v in named_leaves(tree)}


def torch_batch(batch: dict) -> dict:
    """Integer leaves as int64, the frontends' float features as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v))
        out[k] = t if t.is_floating_point() else t.long()
    return out


@contextlib.contextmanager
def ring_lever(on: bool):
    """``REPRO_RING_TP`` for the span: the EXACT projections' ring forms and
    the MoE combine through the int8 ring."""
    prev = moe_mod._MOE_RING
    moe_mod._MOE_RING = bool(on)
    try:
        with kops.ring_tp(on):
            yield
    finally:
        moe_mod._MOE_RING = prev


def step_rank(rank, world, shape, jobs):
    """Each job's train steps on this rank's shards of ``job["state"]`` (a
    global numpy state) and rows of ``job["batch"]``.  Returns, a job, the
    metrics of every step, the collectives of the first, this rank's state
    and its digest; rank 0 adds the gathered state, and with
    ``job["grads"]`` the gathered gradients of one ``value_and_grad`` and
    its collectives; a job with ``expect_raise`` returns the message of the
    ``ValueError`` its step raises; ``job["arch"]`` (default ``ARCH``) names
    the smoke arch and ``job["ring"]`` opens the int8-ring lever."""
    mesh = mesh_for(shape)
    out = []
    for job in jobs:
        model = model_for(job["policy"], job.get("arch", ARCH))
        state = train_state_from_numpy(job["state"], mesh=mesh)
        batch = sharding.shard_batch(torch_batch(job["batch"]), mesh)
        scfg = tstep.StepConfig(remat="none", total_steps=job.get("total", 10), warmup=2,
                                compress_grads=job.get("compress", False))
        deg = None if job.get("degree") is None else torch.tensor(job["degree"],
                                                                  dtype=torch.int32)
        res = {"metrics": []}
        if job.get("expect_raise"):
            try:
                tstep.train_step(model, scfg, state, batch, tp=shape[1], degree=deg)
            except ValueError as e:
                out.append({"raised": str(e)})
                continue
            raise AssertionError("the step did not raise")
        with ring_lever(job.get("ring", False)):
            if job.get("grads"):
                collectives.counter.reset()
                (loss, _), grads = tstep.value_and_grad(model, state.params, batch,
                                                        tp=shape[1], degree=deg,
                                                        remat="none")
                res["grad_bytes"] = collectives.counter.snapshot()
                full = sharding.gather_params(grads, mesh)
                if rank == 0:
                    res["grads"] = to_numpy(full)
            for i in range(job.get("steps", 1)):
                collectives.counter.reset()
                state, met = tstep.train_step(model, scfg, state, batch, tp=shape[1],
                                              degree=deg)
                if i == 0:
                    res["collectives"] = collectives.counter.snapshot()
                res["metrics"].append({k: float(v) for k, v in met.items()})
        res["local"] = to_numpy(state)
        res["digest"] = digest(state)
        full = sharding.gather_train_state(state, mesh)
        if rank == 0:
            res["global"] = to_numpy(full)
        out.append(res)
    return out


def autograd_rank(rank, world, xs, ws, seeds):
    """The three autograd collectives on a (1, world) mesh, each with its
    rank's operands: the gradients every rank computes for its input (see
    tests/test_torch_mesh_train.py::test_autograd_collectives_backward)."""
    mesh = mesh_for((1, world))
    g = mesh.group("model")
    out = {}
    # gather_kv_heads: this rank's columns, gathered, narrowed to the rank's
    # own window of the whole (a different one on every rank), weighted
    x = torch.from_numpy(xs[rank]).requires_grad_()
    full = collectives.gather_kv_heads(x, g)
    width = full.shape[-1] // world
    part = full.narrow(-1, ((rank + 1) % world) * width, width)
    loss = (part * torch.from_numpy(ws[rank])).sum()
    out["gather"] = torch.autograd.grad(loss, x)[0].numpy()
    # reduce_from_model: each rank's partial, summed, a replicated consumer
    x = torch.from_numpy(xs[rank]).requires_grad_()
    y = collectives.reduce_from_model(x * torch.from_numpy(ws[rank]), g)
    loss = torch.sin(y).sum()
    out["reduce"] = torch.autograd.grad(loss, x)[0].numpy()
    # copy_to_model: a replicated input, a rank-specific consumer
    x = torch.from_numpy(xs[0]).requires_grad_()
    y = collectives.copy_to_model(x, g)
    loss = (torch.cos(y) * torch.from_numpy(ws[rank])).sum()
    out["copy"] = torch.autograd.grad(loss, x)[0].numpy()
    return out


def gather_rank(rank, world, xs, ws):
    """``gather_from_model`` and ``ring_reduce_from_model`` on a (1, world)
    mesh: the gradient of each rank's input when every rank's loss is the
    same replicated function of the gathered (reduced) tensor (see
    tests/test_torch_mesh_frontends.py::test_gather_and_ring_backward)."""
    mesh = mesh_for((1, world))
    g = mesh.group("model")
    out = {}
    x = torch.from_numpy(xs[rank]).requires_grad_()
    full = collectives.gather_from_model(x, g, dim=-1)
    loss = (torch.tanh(full) * torch.from_numpy(ws)).sum()
    out["gather"] = torch.autograd.grad(loss, x)[0].numpy()
    x = torch.from_numpy(xs[rank]).requires_grad_()
    y = collectives.ring_reduce_from_model(x, g)
    out["ring"] = torch.autograd.grad((y * torch.from_numpy(ws[:, :y.shape[-1]])).sum(),
                                      x)[0].numpy()
    return out


class _SigtermAt:
    """A pipeline that sends this process SIGTERM when ``at`` is asked for
    (a scheduler's preemption of one rank)."""

    def __init__(self, inner, at):
        self.inner, self.at = inner, at

    def batch_at(self, step):
        if step == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.inner.batch_at(step)


def trainer_rank(rank, world, shape, opts):
    """A ``Trainer`` on this rank of a ``shape`` mesh (tinyllama smoke,
    seq 16, global batch 4, synchronous checkpoints): its history, final
    step, preemption and the checkpoint steps it sees, the digest of its
    last state (rank 0 adds the gathered state); with
    ``opts["sigterm_rank"]`` that rank signals itself at ``opts["sigterm_at"]``;
    ``opts["qos"]``: a ladder 8 -> 7 -> 6 under AXQ checked every 2 steps;
    ``opts["arch"]`` (default ``ARCH``) the smoke arch."""
    mesh = mesh_for(shape)
    policy = opts.get("policy", "exact")
    model = model_for(policy, opts.get("arch", ARCH))
    pipe = make_pipeline(model.cfg, seq_len=16, global_batch=4)
    if opts.get("sigterm_rank") == rank:
        pipe = _SigtermAt(pipe, opts["sigterm_at"])
    qos = (QoSController(ladder=[{"ebits": e} for e in (8, 7, 6)], low_water=1e9,
                         high_water=2e9, cooldown_steps=0)
           if opts.get("qos") else None)
    t = Trainer(model, tstep.StepConfig(remat="none", total_steps=opts.get("schedule", 20),
                                        warmup=2),
                TrainerConfig(total_steps=opts["total"], ckpt_every=opts.get("ckpt_every", 100),
                              ckpt_dir=opts["ckpt_dir"], log_every=1000, qos=qos,
                              qos_every=2, async_ckpt=False),
                pipe, tp=shape[1], mesh=mesh)
    r = t.run()
    out = {"final_step": r["final_step"], "preempted": r["preempted"],
           "losses": [h["loss"] for h in r["history"]],
           "degrees": [h["degree"] for h in r["history"]],
           "steps": [h["step"] for h in r["history"]],
           "saved": t.ckpt.all_steps(), "digest": digest(t.state)}
    full = sharding.gather_train_state(t.state, mesh)
    if rank == 0:
        out["global"] = to_numpy(full)
    return out


def one_rank_grads(job) -> dict:
    """The port's one-process gradients of ``job``'s loss on the whole
    state and batch (a 1x1 mesh in this process), as numpy."""
    with meshctx.use_mesh(meshctx.make_mesh((1, 1), ("data", "model"))):
        model = model_for(job["policy"], job.get("arch", ARCH))
        state = train_state_from_numpy(job["state"])
        (_, _), grads = tstep.value_and_grad(model, state.params, torch_batch(job["batch"]),
                                             tp=job["tp"], remat="none")
    return to_numpy(grads)


def split_collectives_rank(rank, world, xs, ws, w0):
    """``sum_over_model`` and ``sum_grad_columns`` on a (1, world) mesh
    with rank-local consumers: each rank's gradient of its input (see
    tests/test_torch_mesh_recurrent.py::test_split_collectives_backward)."""
    mesh = mesh_for((1, world))
    g = mesh.group("model")
    out = {}
    x = torch.from_numpy(xs[rank]).requires_grad_()
    y = collectives.sum_over_model(torch.square(x).sum(-1, keepdim=True), g)
    loss = (torch.rsqrt(y + 1.0) * x * torch.from_numpy(ws[rank])).sum()
    out["sum"] = torch.autograd.grad(loss, x)[0].numpy()
    w = torch.from_numpy(w0).requires_grad_()
    wc = collectives.sum_grad_columns(w, g, 2, 4)
    loss = (torch.tanh(torch.from_numpy(xs[rank]) @ wc) * torch.from_numpy(ws[rank])).sum()
    out["columns"] = torch.autograd.grad(loss, w)[0].numpy()
    return out


def recurrent_mesh_rank(rank, world, shape, jobs, extra):
    """:func:`step_rank`'s jobs on this rank of ``shape``, then with
    ``extra["trainer"]`` a :func:`trainer_rank` run (its options) and with
    ``extra["one_rank_grads"]`` rank 0's one-process gradients of each
    grads job (``one_rank_grads``)."""
    out = {"steps": step_rank(rank, world, shape, jobs)}
    if rank == 0 and extra.get("one_rank_grads"):
        out["one_rank_grads"] = [one_rank_grads(dict(j, tp=shape[1])) if j.get("grads")
                                 else None for j in jobs]
    for name, opts in extra.get("trainers", {}).items():
        out[name] = trainer_rank(rank, world, shape, opts)
    return out


def roundtrip_rank(rank, world, trees, caches):
    """Each global tree and cache (numpy) cut to this rank's part of a (1,
    world) mesh and gathered back: (the gathered trees and caches as
    numpy, this rank's local shapes)."""
    from repro_torch.convert import cache_from_numpy, params_from_numpy

    mesh = mesh_for((1, world))
    out = {"trees": [], "caches": [], "shapes": []}
    for tree in trees:
        local = sharding.shard_params(params_from_numpy(tree), mesh=mesh)
        out["shapes"].append({n: tuple(v.shape) for n, v in named_leaves(local)})
        out["trees"].append(to_numpy(sharding.gather_params(local, mesh)))
    for cache in caches:
        local = sharding.shard_cache(cache_from_numpy(cache), mesh=mesh)
        out["shapes"].append({n: tuple(v.shape) for n, v in named_leaves(local)})
        out["caches"].append(to_numpy(sharding.gather_cache(local, mesh)))
    return out
