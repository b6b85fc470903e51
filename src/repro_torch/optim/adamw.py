"""AdamW + global-norm clipping + the cosine warmup schedule, pure-tree
style (the port of ``repro.optim.adamw``).

Parameters, gradients and the moments are nested dicts of tensors; every
tree walk takes the reference's leaf order (dict keys sorted), so the f32
sums of :func:`global_norm` add the leaves in the same order.  The update
is functional: it returns new tensors and leaves its inputs untouched.
On a mesh every tree holds this rank's shards: the update is elementwise
on them, and only :func:`global_norm` reduces over the ``model`` group.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.dist import collectives, meshctx, sharding
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


class AdamWState(NamedTuple):
    step: Tensor       # () int32
    mu: Any            # tree like params (f32)
    nu: Any            # tree like params (f32)


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    dev = tree_leaves(params)[0].device
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), zeros,
                      tree_map(torch.clone, zeros))


def global_norm(tree) -> Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves added in
    tree order from 0.  On a mesh ``tree`` holds this rank's shards: the
    sums of squares of the leaves split over ``model`` are summed over the
    ``model`` group (one all-reduce of them all), a replicated leaf's
    counted once, so every rank holds the global norm.  A leaf cut part by
    part (``sharding.split_columns``: a Mamba-2 block's ``in_proj`` and
    conv, whose B / C columns every rank holds whole) adds the summed sum
    of squares of its split columns to its replicated columns' once."""
    leaves = [x.to(torch.float32) for x in tree_leaves(tree)]
    sq = [torch.sum(torch.square(x)) for x in leaves]
    mesh = meshctx.get_mesh()
    if mesh.size("model") > 1 and sq:
        split = sharding.split_columns(tree, mesh)
        if any(m is not False for m in split):
            local, whole = [], []
            for x, s, m in zip(leaves, sq, split):
                if isinstance(m, sharding.ColumnSplit):
                    local.append(torch.sum(torch.square(x.index_select(-1, m.split))))
                    whole.append(torch.sum(torch.square(x.index_select(-1, m.whole))))
                else:
                    local.append(s if m else torch.zeros_like(s))
                    whole.append(None)
            summed = collectives.all_reduce(torch.stack(local), mesh.group("model")).unbind(0)
            sq = [s if m is False else (t if w is None else t + w)
                  for s, t, w, m in zip(sq, summed, whole, split)]
    total = 0
    for s in sq:
        total = total + s
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _decay_mask(p: Tensor) -> bool:
    """No weight decay on 1-d params.  As in the reference the test is on
    the stacked leaf, so the layers' (L, d) norm scales are decayed."""
    return p.dim() >= 2


def update(cfg: AdamWConfig, state: AdamWState, params, grads, lr_scale=1.0):
    """Returns (new_params, new_state, metrics).  ``lr_scale`` may be a
    device scalar (the schedule's): nothing here reads the device."""
    grads = tree_map(lambda g: g.to(torch.float32), grads)
    if cfg.clip_norm:
        grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    else:
        gnorm = global_norm(grads)
    step = state.step + 1
    stepf = step.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32, device=stepf.device),
                          stepf)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32, device=stepf.device),
                          stepf)
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mhat = m2 / b1c
        vhat = v2 / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        if _decay_mask(p):
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2

    out = [upd(*leaves) for leaves in zip(*(tree_leaves(t) for t in
                                             (params, grads, state.mu, state.nu)))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out]) for i in range(3))
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def cosine_warmup(step: Tensor, *, warmup: int, total: int,
                  min_ratio: float = 0.1) -> Tensor:
    """Linear warmup then cosine decay to ``min_ratio``, in f32 on
    ``step``'s device."""
    s = step.to(torch.float32)
    warm = torch.clamp((s + 1.0) / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
