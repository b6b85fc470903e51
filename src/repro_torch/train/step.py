"""Train / eval / serve step functions (the port of ``repro.train.step``).

``train_step`` is forward + backward (remat policy configurable) + gradient
clipping + AdamW, with optional microbatch gradient accumulation and the
compressed gradient all-reduce.  It runs eagerly: the reference's jitted
step becomes one autograd pass over the state's parameter leaves (the
kernels' forwards, their backward oracles), then the functional update.
The step counter and the degree stay device tensors: nothing here reads
the device.

On a mesh (``dist/meshctx.py``: one process a rank, the state this rank's
shards, ``dist.sharding.shard_train_state``; the batch this rank's rows)
the step computes the reference's one-device step on the global state:
the model's collectives carry the gradients inside the backward, then
every gradient leaf is summed over the ``data`` group (each data rank's
loss is its share of the global masked mean plus its share of the data
shards' mean aux loss), ``compress_grads``
quantizes the global gradient (a sharded leaf against the whole leaf's
amax), the norm is the global one (``adamw.global_norm``), and the
reported ``loss`` / ``ce`` are the global ones, the same bits on every
rank, and the reported ``aux`` the data ranks' mean.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.dist import collectives, meshctx, sharding
from repro_torch.models.registry import Model
from repro_torch.optim import adamw
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState
    step: Tensor  # () int32 — global step (mirrors opt.step; kept for restore)


@dataclass(frozen=True)
class StepConfig:
    optimizer: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    remat: str = "dots"          # none | dots | full
    grad_accum: int = 1          # microbatches per step
    warmup: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False  # int8 + error-feedback all-reduce emulation


def init_state(model: Model, seed: int = 0, tp: int = 1,
               generator: Optional[torch.Generator] = None, mesh=None) -> TrainState:
    """The seeded state; with ``mesh`` this rank's part of it: the global
    parameters built from the seed, then cut to the rank's shards, and
    AdamW's state made on the shards."""
    params = model.init(seed, tp, generator=generator)
    if mesh is not None:
        params = sharding.shard_params(params, mesh=mesh)
    return TrainState(params, adamw.init(params),
                      torch.zeros((), dtype=torch.int32, device=model.device))


def _split_microbatches(batch: dict, n: int) -> list:
    if any(v.shape[0] % n for v in batch.values()):
        raise ValueError(f"batch of {next(iter(batch.values())).shape[0]} rows does not "
                         f"split into {n} microbatches")
    parts = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:]) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def value_and_grad(model: Model, params, batch: dict, tp: int = 1, degree=None,
                   remat: str = "dots"):
    """((loss, metrics), grads): the loss and its gradient for every leaf
    of ``params`` (a tree of the same structure)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    live = tree_unflatten(params, leaves)
    with torch.enable_grad():
        loss, metrics = model.loss(live, batch, tp=tp, degree=degree, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), tree_unflatten(params, grads)


def train_step(model: Model, cfg: StepConfig, state: TrainState, batch: dict,
               tp: int = 1, degree=None):
    """Returns (new_state, metrics); the state passed in is left as it was."""
    if cfg.grad_accum > 1:
        gsum = lsum = metrics = None
        for mb in _split_microbatches(batch, cfg.grad_accum):
            (loss, metrics), grads = value_and_grad(model, state.params, mb, tp, degree,
                                                    cfg.remat)
            grads = tree_map(lambda g: g.to(torch.float32), grads)
            gsum = grads if gsum is None else tree_map(torch.add, gsum, grads)
            lsum = loss if lsum is None else lsum + loss
        grads = tree_map(lambda g: g / cfg.grad_accum, gsum)
        loss = lsum / cfg.grad_accum
    else:
        (loss, metrics), grads = value_and_grad(model, state.params, batch, tp, degree,
                                                cfg.remat)

    mesh = meshctx.get_mesh()
    dgroup = meshctx.data_group(mesh)
    if dgroup is not None:
        grads = tree_map(lambda g: collectives.all_reduce(g, dgroup), grads)
        loss, metrics = _global_metrics(loss, metrics, dgroup)
    if cfg.compress_grads:
        grads = collectives.compress_tree_for_allreduce(grads, group=mesh.group("model"))

    lr_scale = adamw.cosine_warmup(state.step, warmup=cfg.warmup, total=cfg.total_steps)
    new_params, new_opt, opt_metrics = adamw.update(
        cfg.optimizer, state.opt, state.params, grads, lr_scale)
    metrics = {**metrics, **opt_metrics, "loss": loss, "lr_scale": lr_scale}
    return TrainState(new_params, new_opt, state.step + 1), metrics


def _global_metrics(loss, metrics: dict, group):
    """The data ranks' shares of the loss and ``ce`` summed over ``group``
    and their ``aux`` averaged (the reference's ``pmean``), in one
    all-reduce; ``ntokens`` is already global."""
    out = collectives.all_reduce(torch.stack([loss, metrics["ce"], metrics["aux"]]), group)
    aux = out[2] / collectives.group_size(group)
    return out[0], {**metrics, "ce": out[1], "aux": aux}


def eval_step(model: Model, state: TrainState, batch: dict, tp: int = 1, degree=None):
    with torch.no_grad():
        loss, metrics = model.loss(state.params, batch, tp=tp, degree=degree, remat="none")
    dgroup = meshctx.data_group()
    if dgroup is not None:
        loss, metrics = _global_metrics(loss, metrics, dgroup)
    return {**metrics, "loss": loss}


def serve_step(model: Model, params, cache, tokens: Tensor, tp: int = 1, degree=None):
    """One-token decode."""
    with torch.no_grad():
        return model.decode_step(params, cache, tokens, tp=tp, degree=degree)
