"""Mixture-of-Experts block, in PyTorch, on one device or expert-parallel.

Port of ``repro.models.moe``.  The reference runs the block inside a
shard_map over the ``model`` mesh axis: the router replicated, the experts
sharded, a psum combining the shards.  The port does the same on a mesh
whose ``model`` axis is wider than 1 (``dist/meshctx.py``): rank r holds
experts ``[r E/tp, (r+1) E/tp)`` (``dist/sharding.py``), routes every token
with the replicated router, dispatches only the assignments to its own
experts (the reference's ``is_local`` and rank-by-cumsum, at the global
capacity), runs the expert-batched launches on its E/tp experts, and the
ranks' partial outputs are summed by an exact all-reduce in f32
(``collectives.reduce_from_model``) — or, under ``REPRO_RING_TP=1``, by
the int8 ring (the reference's ``_ring_psum_model``,
``collectives.ring_reduce_from_model``); both pass the cotangent back
unchanged, as the reference's psum with a replicated output does.  When
serving, the aux loss needs no collective: every rank routes the same
tokens with the same router, so the reference's mean over ``model`` is
each rank's own value.  Shared experts follow the column / row rules of
the dense MLP.  On one device (tp = 1) every expert is local and the
combine needs no collective.

Training on a mesh (the reference's shard_map transposed): the dispatched
rows and the gates carry a gradient only for this rank's experts, so both
cross ``collectives.copy_to_model``, whose backward sums their cotangents
over ``model`` (the transpose of the reference's replicated ``in_specs``).
The router, its softmax and the aux loss then see the whole cotangent on
every rank and compute the whole router gradient there, the same bits on
every rank, with no further collective; the aux loss is every rank's
whole value, counted once.  On the data axis capacity is per data shard:
``t`` is this rank's rows, the reference's ``T_local = (B // dp) * S``,
and the aux loss is this shard's (``transformer.lm_loss`` averages it over
``data``, as the reference's ``pmean`` does).

Routing (sort-free, all shapes static, nothing read on the host, so the
decode step stays one CUDA graph): an f32 router product, softmax, top-k
(descending, ties to the lower expert, as ``jax.lax.top_k``), gates
renormalised; each (token, k) assignment is ranked within its expert by a
cumsum over the flat ``(token, k)`` order, and the ranks below the
capacity ``C`` are kept.  Kept rows are gathered into an ``(E, C, d)``
buffer, the expert FFNs run as expert-batched GEMMs (one
``axqmm_gated_experts`` and one ``axqmm_experts`` launch on the AXQ route,
the counterpart of the reference's ``vmap`` of its Pallas calls), and the
gated rows are summed back per token in a fixed order.  Every expert runs
its whole capacity buffer, so each decode tick reads every expert's
weights.
"""

from __future__ import annotations

import math
import os

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.approx import ApproxMode, ApproxPolicy, ApproxSpec
from repro_torch.dist import collectives, meshctx
from repro_torch.models.layers import (act_fn, column_input, gated_mlp_apply,
                                       truncated_normal)

Tensor = torch.Tensor

# the pre-dispatch int8 expert lever: promotes an EXACT expert spec to AXQ-8
_MOE_INT8 = os.environ.get("REPRO_MOE_INT8", "0") == "1"
# the combine through the int8 ring all-reduce (on a mesh; no-op on one device)
_MOE_RING = os.environ.get("REPRO_RING_TP", "0") == "1"


def init_moe(gen: torch.Generator, cfg: ArchConfig, tp: int = 1, stack: tuple = (),
             device="cpu"):
    """Router (d, E), experts up/gate (E, d, f) and down (E, f, d), and the
    shared experts' gated MLP when the config has them; ``stack`` prepends
    leading dims (stacked layers)."""
    m = cfg.moe
    E, d, f = cfg.padded(tp).n_experts, cfg.d_model, m.d_expert
    tn = lambda shape, std: truncated_normal(gen, (*stack, *shape), std, device)
    params = {
        "router": {"w": tn((d, E), 1.0 / math.sqrt(d))},
        "experts": {
            "up": tn((E, d, f), 1.0 / math.sqrt(d)),
            "gate": tn((E, d, f), 1.0 / math.sqrt(d)),
            "down": tn((E, f, d), 1.0 / math.sqrt(f)),
        },
    }
    if m.n_shared:
        fs = m.d_shared * m.n_shared
        params["shared"] = {
            "up": tn((d, fs), 1.0 / math.sqrt(d)),
            "gate": tn((d, fs), 1.0 / math.sqrt(d)),
            "down": tn((fs, d), 1.0 / math.sqrt(fs)),
        }
    return params


def expert_spec(policy: ApproxPolicy, path: str) -> ApproxSpec:
    """Expert GEMM spec: policy-resolved at ``<path>/experts``; the
    REPRO_MOE_INT8 lever promotes an EXACT spec to AXQ-8.  One source for
    :func:`moe_apply` and the prepack walker (``kernels/qstore.py``): the
    experts are packed iff they will route AXQ."""
    spec = policy.spec_for(path + "/experts")
    if _MOE_INT8 and spec.mode == ApproxMode.EXACT:
        spec = ApproxSpec(mode=ApproxMode.AXQ, ebits=8)
    return spec


def _local_expert_ffn(w, x: Tensor, act: str, spec=None, ebits=None) -> Tensor:
    """x (E, C, d) -> (E, C, d) f32; ``w`` up/gate (E, d, f) and down
    (E, f, d), float or prepacked with a leading E.  AXQ specs take the
    expert-batched routers with the straight-through backward; ``ebits`` is
    the runtime degree already resolved against the spec.  Other specs run
    the exact f32 product, as the reference's einsum does."""
    from repro_torch.kernels import dispatch as kdispatch  # lazy: import cycle

    if spec is not None and spec.mode == ApproxMode.AXQ:
        h = kdispatch.axq_gated_experts(x.to(torch.float32), w["up"], w["gate"], act=act,
                                        block=spec.block, ebits=ebits, ste=True)
        return kdispatch.axq_matmul_experts(h.to(x.dtype).to(torch.float32), w["down"],
                                            block=spec.block, ebits=ebits, ste=True)
    x32 = x.to(torch.float32)
    up = torch.einsum("ecd,edf->ecf", x32, w["up"].to(torch.float32))
    gate = torch.einsum("ecd,edf->ecf", x32, w["gate"].to(torch.float32))
    h = (act_fn(act)(gate) * up).to(x.dtype)
    return torch.einsum("ecf,efd->ecd", h.to(torch.float32), w["down"].to(torch.float32))


def capacity(cfg: ArchConfig, tokens: int, tp: int = 1) -> int:
    """Rows each expert takes in a call of ``tokens`` rows (every row of the
    call, free decode slots included; on a mesh this rank's rows, the
    reference's per-data-shard ``T_local``), at least 4."""
    m = cfg.moe
    E = cfg.padded(tp).n_experts
    return max(int(math.ceil(tokens * m.top_k / E * m.capacity_factor)), 4)


def route(router_w: Tensor, xt: Tensor, cfg: ArchConfig, tp: int = 1):
    """Router of ``xt`` (t, d): returns (gates (t, k) f32 renormalised,
    expert ids (t, k) int64 descending by probability, probs (t, E) f32)."""
    m = cfg.moe
    E = cfg.padded(tp).n_experts
    pad = torch.where(torch.arange(E, device=xt.device) < m.n_experts, 0.0, -1e9)
    logits = xt.to(torch.float32) @ router_w.to(torch.float32) + pad
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort: ties keep the lower expert first, as
    # jax.lax.top_k does (the k order decides which rows capacity drops)
    gate_vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, ids = gate_vals[:, :m.top_k], ids[:, :m.top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return gate_vals, ids, probs


def dispatch_plan(ids: Tensor, C: int, E: int):
    """The capacity dispatch of expert ids (t, k): each flat ``(token, k)``
    assignment's rank within its expert (a cumsum in flat order) and
    whether it is kept (rank < C).  Returns (flat ids, ranks, keep)."""
    flat = ids.reshape(-1)
    onehot = (flat[:, None] == torch.arange(E, device=ids.device)[None]).to(torch.int32)
    ranks = torch.cumsum(onehot, dim=0) - onehot
    slot = (ranks * onehot).sum(dim=-1)
    return flat, slot, slot < C


def moe_apply(params, x: Tensor, cfg: ArchConfig, policy: ApproxPolicy, path: str,
              degree=None) -> tuple[Tensor, Tensor]:
    """x (B, S, d) -> (y (B, S, d) in x.dtype, aux load-balance loss (f32
    scalar)).  On a mesh ``params`` holds this rank's experts (module
    docstring)."""
    mesh = meshctx.get_mesh()
    tp = mesh.size("model")
    m = cfg.moe
    E, topk = cfg.padded(tp).n_experts, m.top_k
    E_loc = E // tp
    e0 = mesh.coord("model") * E_loc
    B, S, d = x.shape
    t = B * S
    C = capacity(cfg, t, tp)
    espec = expert_spec(policy, path)
    e_run = degree if (espec.dynamic and degree is not None) else espec.ebits

    xt = x.reshape(t, d)
    gate_vals, ids, probs = route(params["router"]["w"], xt, cfg, tp)

    # aux load-balance loss (Switch-style): E * sum_e f_e * p_e; the counts
    # are whole numbers, exact in f32 in any order
    me = probs.mean(dim=0)
    counts = torch.zeros((E,), dtype=torch.float32, device=x.device).scatter_add_(
        0, ids.reshape(-1), torch.ones((t * topk,), dtype=torch.float32, device=x.device))
    aux = E * torch.sum(me * (counts / (t * topk)))

    flat, slot, keep = dispatch_plan(ids, C, E)
    group = mesh.group("model") if tp > 1 else None
    if group is not None and torch.is_grad_enabled():
        # this rank's experts' share of the rows' and the gates' cotangents
        # (module docstring)
        gate_vals = collectives.copy_to_model(gate_vals, group)
        xt = collectives.copy_to_model(xt, group)
    if tp > 1:
        # this rank's experts only; the ranks within an expert are the
        # global ones (a cumsum per expert), so capacity drops the same rows
        keep = keep & (flat >= e0) & (flat < e0 + E_loc)
        flat = flat - e0
    tok = torch.arange(t * topk, device=x.device) // topk
    # kept rows to their (expert, rank) row of the buffer; dropped rows to
    # one spare row past it, which is cut off (a plain copy: no row is
    # summed onto another)
    dst = torch.where(keep, flat * C + slot, E_loc * C)
    buf = torch.zeros((E_loc * C + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dst, xt[tok])
    y_buf = _local_expert_ffn(params["experts"], buf[:E_loc * C].view(E_loc, C, d),
                              cfg.act, espec, e_run).to(x.dtype)

    rows = y_buf.reshape(E_loc * C, d)[torch.where(keep, flat * C + slot, 0)]
    rows = torch.where(keep[:, None], rows, 0) * gate_vals.reshape(-1)[:, None].to(x.dtype)
    # each token's k rows summed in k order, in x.dtype (the reference's
    # scatter-add order; no atomics)
    rows = rows.view(t, topk, d)
    yt = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    for j in range(topk):
        yt = yt + rows[:, j]
    if tp > 1:
        if _MOE_RING:
            yt = collectives.ring_reduce_from_model(yt, group)
        else:
            yt = collectives.reduce_from_model(yt.to(torch.float32), group).to(x.dtype)
    y = yt.view(B, S, d)

    if "shared" in params:
        sh = params["shared"]
        xs = column_input(x, policy, (path + "/shared/up", path + "/shared/gate"))
        shared = gated_mlp_apply({"up": {"w": sh["up"]}, "gate": {"w": sh["gate"]},
                                  "down": {"w": sh["down"]}},
                                 xs, policy, path + "/shared", act=cfg.act, degree=degree)
        y = y + shared
    return y, aux
