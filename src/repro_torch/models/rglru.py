"""RecurrentGemma / Griffin hybrid in PyTorch: RG-LRU recurrent blocks and
local attention, stacked in the (rec, rec, attn) pattern (arXiv:2402.19427).

Port of ``repro.models.rglru``:

    r_t = sigmoid(W_a x_t)                      recurrence gate
    i_t = sigmoid(W_x x_t)                      input gate
    a_t = exp(-c * softplus(Lambda) * r_t)      per-channel decay, c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Prefill runs the linear recurrence as a Hillis-Steele doubling scan:
ceil(log2 S) whole-tensor steps of ``(a1 a2, a2 b1 + b2)``, each position
combined with the one ``2^k`` before it.  A position's value depends only
on the positions at or before it, so the scan does not depend on the padded
length: a bucket-padded prefill gives the exact-length states bit for bit
(the reference's ``jax.lax.associative_scan`` agrees within f32 rounding).
No TPU kernel computes the recurrence; it stays plain PyTorch.  Decode is
the O(1) update.

Parameters: ``groups`` holds each pattern block's parameters stacked over
the ``n_layers // len(pattern)`` groups (looped in Python, as the reference
scans them), ``tail`` the ``n_layers % len(pattern)`` trailing recurrent
blocks.  Layer ``g * len(pattern) + i`` is block ``i`` of group ``g``, the
tail blocks last: the group-major order of the per-site degree vector.

The cache (:class:`HybridCache`) is updated in place: the recurrent states
``h`` and conv tails of every recurrent block, and each group's attention
K/V ring of ``min(local_window, max_len)`` positions.

Tensor parallelism (a mesh whose ``model`` axis is wider than 1, serving
and training alike): the RG-LRU is channel-wise, so a rank holds its
channels of everything in the recurrent block (``dist/sharding.py``):
``wx`` / ``wg`` / ``wa`` / ``wi`` column-parallel, the conv taps and
``lam``, the state and the conv tail; ``wo`` and the MLP's ``down`` are
row-parallel (their partials all-reduced).  The normed inputs of the
column-parallel projections pass ``layers.column_input``; no other
collective is needed.  The attention blocks are the dense family's
(``transformer.block_apply``): MQA at tp=2 takes its kv-split path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.approx import ApproxPolicy
from repro_torch.dist import meshctx
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.cache_ops import cache_reset_slot, ring_write_indices
from repro_torch.models.degrees import split_degree
from repro_torch.models.ssm import _conv_tail, init_conv_tail, tail_decoded, tail_value

Tensor = torch.Tensor
_C = 8.0


def _counts(cfg: ArchConfig):
    """(pattern, groups, tail blocks, recurrent blocks a group)."""
    pat = cfg.block_pattern
    n_groups, tail = divmod(cfg.n_layers, len(pat))
    return pat, n_groups, tail, sum(1 for p in pat if p == "rec")


def _group_degrees(degree, cfg: ArchConfig, device=None):
    """Split a runtime degree into (per-group (n_groups, len(pattern))
    degrees, per-tail-block degrees, the head's), in the group-major layer
    order: layer ``g * len(pattern) + i`` is block ``i`` of group ``g``; tail
    blocks come last.  Device degrees stay views (the kernels read them by
    address); host ones nested lists."""
    ldeg, hdeg = split_degree(degree, cfg.n_layers, device)
    if ldeg is None:
        return None, None, None
    pat, n_groups, _, _ = _counts(cfg)
    n = n_groups * len(pat)
    if isinstance(ldeg, Tensor):
        gdeg = ldeg[:n].reshape(n_groups, len(pat))
    else:
        gdeg = [ldeg[g * len(pat):(g + 1) * len(pat)] for g in range(n_groups)]
    return gdeg, ldeg[n:], hdeg


def _site(deg, *idx):
    for i in idx:
        if deg is None:
            return None
        deg = deg[i]
    return deg


# ---------------------------------------------------------------------------
# RG-LRU block
# ---------------------------------------------------------------------------


def init_rec_block(gen: torch.Generator, cfg: ArchConfig, stack: tuple = (), device="cpu"):
    d = cfg.d_model
    lam = (torch.rand((*stack, d), generator=gen, device=device)
           * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2)
    return {
        "ln1": L.init_rmsnorm(d, stack, device),
        "ln2": L.init_rmsnorm(d, stack, device),
        "wx": L.init_dense(gen, d, d, stack=stack, device=device),     # input branch
        "wg": L.init_dense(gen, d, d, stack=stack, device=device),     # gate branch (GeLU)
        "conv": L.init_conv1d(gen, d, 4, stack, device),
        "wa": L.init_dense(gen, d, d, stack=stack, device=device),     # recurrence gate
        "wi": L.init_dense(gen, d, d, stack=stack, device=device),     # input gate
        # a = lam^(c r): softplus(Lambda) = -log(lam) / c
        "lam": torch.log(torch.expm1(-torch.log(lam) / _C)),
        "wo": L.init_dense(gen, d, d, scale=1.0 / math.sqrt(d), stack=stack, device=device),
        "mlp": L.init_gated_mlp(gen, d, cfg.d_ff, stack, device),
    }


def _rglru_scan(x: Tensor, a: Tensor, h0: Tensor | None = None) -> Tensor:
    """The linear recurrence h_t = a_t h_{t-1} + x_t over (B, S, d) f32, as
    a Hillis-Steele doubling scan of the reference's combine
    ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``.  Returns every h_t."""
    if h0 is not None:                 # the initial state folds into step 0
        x = torch.cat([x[:, :1] + a[:, :1] * h0[:, None], x[:, 1:]], dim=1)
    S = x.shape[1]
    k = 1
    while k < S:
        x = torch.cat([x[:, :k], a[:, k:] * x[:, :-k] + x[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], dim=1)
        k *= 2
    return x


def rec_block_apply(bp, x: Tensor, cfg: ArchConfig, policy: ApproxPolicy, path: str,
                    degree=None, state=None, lengths: Tensor | None = None):
    """Pre-norm residual recurrent block.  ``state`` = (h (B, d), conv
    (B, 3, d)) for decode, None for prefill.  Returns (x_out, (new h, new
    conv)).  ``lengths`` (B,) gathers the state at each row's true length
    instead of the last position (the bucketed prefill; a row of length 0
    gets a zero state)."""
    h_in = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
    h_in = L.column_input(h_in, policy, tuple(f"{path}/{k}" for k in ("wx", "wg", "wa", "wi")))
    xb = L.dense_apply(bp["wx"], h_in, policy, path + "/wx", degree)
    gb = L.dense_apply(bp["wg"], h_in, policy, path + "/wg", degree)
    conv_in = xb
    xb, new_conv = L.conv1d_apply(bp["conv"], xb, None if state is None else state[1])
    r = torch.sigmoid(L.dense_apply(bp["wa"], h_in, policy, path + "/wa",
                                    degree).to(torch.float32))
    i = torch.sigmoid(L.dense_apply(bp["wi"], h_in, policy, path + "/wi",
                                    degree).to(torch.float32))
    a = torch.exp(-_C * F.softplus(bp["lam"]) * r)   # (B, S, d) f32
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb.to(torch.float32))
    if state is None:
        hseq = _rglru_scan(gated_in, a)
        if lengths is None:
            new_h = hseq[:, -1]
        else:
            B, S = hseq.shape[:2]
            idx = torch.clamp(lengths.to(torch.int64) - 1, 0, S - 1)
            new_h = hseq[torch.arange(B, device=x.device), idx]
            new_h = torch.where(lengths[:, None] > 0, new_h, 0.0)
            new_conv = _conv_tail(conv_in, lengths, bp["conv"]["w"].shape[0])
    else:
        hseq = (a[:, 0] * state[0] + gated_in[:, 0])[:, None]
        new_h = hseq[:, 0]
    y = hseq.to(x.dtype) * L.act_rounded("gelu")(gb)
    # the residual adds ride the projections' epilogues (in-kernel on AXQ)
    x = L.dense_apply(bp["wo"], y, policy, path + "/wo", degree, residual=x)
    h2 = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    h2 = L.column_input(h2, policy, (path + "/mlp/up", path + "/mlp/gate"))
    out = L.gated_mlp_apply(bp["mlp"], h2, policy, path + "/mlp", cfg.act, degree,
                            residual=x)
    return out, (new_h, new_conv)


# ---------------------------------------------------------------------------
# local-attention block (window = cfg.local_window)
# ---------------------------------------------------------------------------


def _local(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, swa_window=cfg.local_window, moe=None)


def attn_block_apply(bp, x, cfg: ArchConfig, tp, policy, path, positions, degree=None,
                     return_kv: bool = False):
    """The dense block at ``swa_window = local_window``."""
    return T.block_apply(bp, x, _local(cfg), tp, policy, path, positions, degree,
                         return_kv=return_kv)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


def init_hybrid(gen: torch.Generator, cfg: ArchConfig, tp: int = 1, device="cpu"):
    pat, n_groups, tail, _ = _counts(cfg)
    st = (n_groups,)
    groups = {f"{name}{i}": (init_rec_block(gen, cfg, st, device) if name == "rec"
                             else T.init_block(gen, cfg, tp, st, device))
              for i, name in enumerate(pat)}
    return {
        "embed": L.init_embedding(gen, cfg.padded(tp).vocab, cfg.d_model, device),
        "groups": groups,
        "ln_f": L.init_rmsnorm(cfg.d_model, device=device),
        "unembed": L.init_dense(gen, cfg.d_model, cfg.padded(tp).vocab,
                                scale=1.0 / math.sqrt(cfg.d_model), device=device),
        "tail": [init_rec_block(gen, cfg, (), device) for _ in range(tail)],
    }


def hybrid_forward(params, cfg: ArchConfig, policy: ApproxPolicy, batch: dict, tp: int = 1,
                   degree=None, remat: str = "dots") -> tuple[Tensor, Tensor]:
    """Returns (logits (B, S, vocab_padded) f32, a zero aux loss).  Under
    autograd each (rec, rec, attn) group runs under ``remat``
    (``transformer.remat_call``); the tail blocks keep their activations,
    as in the reference."""
    tokens = batch["tokens"]
    gdeg, tdeg, hdeg = _group_degrees(degree, cfg, tokens.device)
    pat, n_groups, _, _ = _counts(cfg)
    x = L.embed_apply(params["embed"], tokens, T._dtype(cfg))
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)

    def group_body(gp, h, g):
        for i, name in enumerate(pat):
            bp, di = gp[f"{name}{i}"], _site(gdeg, g, i)
            if name == "rec":
                h, _ = rec_block_apply(bp, h, cfg, policy, f"g/{name}{i}", di)
            else:
                h = attn_block_apply(bp, h, cfg, tp, policy, f"g/{name}{i}", positions, di)
        return h

    for g in range(n_groups):
        x = T.remat_call(remat, group_body, T.layer_params(params["groups"], g), x, g)
    for i, bp in enumerate(params["tail"]):
        x, _ = rec_block_apply(bp, x, cfg, policy, f"tail/{i}", _site(tdeg, i))
    return (T._head(params, cfg, policy, x, hdeg),
            torch.zeros((), dtype=torch.float32, device=tokens.device))


class HybridCache(NamedTuple):
    k: Tensor       # (n_groups, B, W, KVr, D): each group's attention ring
    v: Tensor
    h: Tensor       # (n_rec, B, d) f32: every recurrent block's state
    conv: Tensor    # (n_rec, B, 3, d): its conv tail
    length: Tensor  # (B,) int32


def init_hybrid_cache(cfg: ArchConfig, tp: int, batch: int, max_len: int,
                      dtype=torch.bfloat16, device="cpu") -> HybridCache:
    """The cache of this rank's kv heads and channels (all of them on one
    device)."""
    _, n_groups, tail, rec = _counts(cfg)
    n_rec = n_groups * rec + tail
    W = min(cfg.local_window or max_len, max_len)
    kv = (n_groups, batch, W, T.tp_heads(cfg, tp)[1], cfg.head_dim)
    m = meshctx.model_size()
    if cfg.d_model % m:
        raise ValueError(f"{cfg.name}: d_model {cfg.d_model} does not split over tp={m}")
    d = cfg.d_model // m
    return HybridCache(
        k=torch.zeros(kv, dtype=dtype, device=device),
        v=torch.zeros(kv, dtype=dtype, device=device),
        h=torch.zeros((n_rec, batch, d), dtype=torch.float32, device=device),
        conv=init_conv_tail((n_rec, batch, 3, d), cfg, dtype, device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device))


def _ring(cfg: ArchConfig, W: int) -> bool:
    """Ring writes hold only while decode also ring-wraps (window <= W); a
    capacity-truncated window cache saturates instead."""
    return cfg.local_window is not None and cfg.local_window <= W


def _blocks(params, cfg: ArchConfig):
    """Every block in layer order: (group or None, pattern name, params,
    its index among the recurrent blocks or None, degree site)."""
    pat, n_groups, _, _ = _counts(cfg)
    ri = 0
    for g in range(n_groups):
        gp = T.layer_params(params["groups"], g)
        for i, name in enumerate(pat):
            yield g, name, gp[f"{name}{i}"], (ri if name == "rec" else None), (g, i)
            ri += name == "rec"
    for i, bp in enumerate(params["tail"]):
        yield None, "rec", bp, ri + i, i


def _degree_of(gdeg, tdeg, g, site):
    return _site(tdeg, site) if g is None else _site(gdeg, *site)


def hybrid_prefill(params, cfg: ArchConfig, policy: ApproxPolicy, cache: HybridCache,
                   tokens: Tensor, slot, tp: int = 1, degree=None):
    """Fused prefill: one forward over the prompt; the recurrent and conv
    states and the local-attention K/V (ring-wrapped to the window) are
    written into ``slot``'s region in place (the region is reset first).

    tokens: (P,) int.  Returns (last-position logits (1, V) f32, the cache
    with ``length[slot] = P``)."""
    gdeg, tdeg, hdeg = _group_degrees(degree, cfg, tokens.device)
    cache_reset_slot(cache, slot)
    P = tokens.shape[0]
    W = cache.k.shape[2]
    if P > W and not _ring(cfg, W):
        raise ValueError(f"prompt ({P}) exceeds cache capacity ({W})")
    x = L.embed_apply(params["embed"], tokens[None], T._dtype(cfg))      # (1, P, d)
    positions = torch.arange(P, dtype=torch.int32, device=tokens.device)[None]
    src, dst = ring_write_indices(P, W, tokens.device)
    for g, name, bp, ri, site in _blocks(params, cfg):
        # path "g" / "tail" as decode: a path-keyed policy resolves alike
        path, di = ("tail" if g is None else "g"), _degree_of(gdeg, tdeg, g, site)
        if name == "rec":
            x, (nh, nc) = rec_block_apply(bp, x, cfg, policy, path, di)
            cache.h[ri, slot] = nh[0]
            cache.conv[ri, slot] = tail_value(cache.conv, nc[0])
        else:
            x, (k, v) = attn_block_apply(bp, x, cfg, tp, policy, path, positions, di,
                                         return_kv=True)
            cache.k[g, slot, dst] = k[0, src].to(cache.k.dtype)
            cache.v[g, slot, dst] = v[0, src].to(cache.v.dtype)
    cache.length[slot] = P
    return T._head(params, cfg, policy, x[:, -1:], hdeg)[:, 0], cache


def hybrid_prefill_batch(params, cfg: ArchConfig, policy: ApproxPolicy, cache: HybridCache,
                         tokens: Tensor, slots, lengths, tp: int = 1,
                         degree=None) -> HybridCache:
    """Bucketed/packed prefill: rows (N, Pb) padded to one bucket length
    into ``slots`` with true ``lengths`` (device tensors: no host read,
    capturable; or host integers), in place.  The recurrent and conv states
    are gathered at each row's length (the doubling scan's prefixes do not
    depend on the padding) and the attention K/V lands by the dense
    family's write plan (the last ``min(length, W)`` tokens at ``j % W``,
    zeros elsewhere) — per row bit-identical to :func:`hybrid_prefill` at
    the exact length.  A row with ``slot`` outside ``[0, B)`` writes
    nothing.  Returns the cache."""
    gdeg, tdeg, _ = _group_degrees(degree, cfg, tokens.device)
    N, Pb = tokens.shape
    B, W = cache.k.shape[1], cache.k.shape[2]
    if Pb > W and not _ring(cfg, W):
        raise ValueError(f"bucket ({Pb}) exceeds cache capacity ({W})")
    plan = T.state_write_plan(tokens, slots, lengths, B, W)
    x = L.embed_apply(params["embed"], tokens, T._dtype(cfg))            # (N, Pb, d)
    positions = torch.arange(Pb, dtype=torch.int32, device=tokens.device)[None].expand(N, Pb)
    for g, name, bp, ri, site in _blocks(params, cfg):
        path, di = ("tail" if g is None else "g"), _degree_of(gdeg, tdeg, g, site)
        if name == "rec":
            x, (nh, nc) = rec_block_apply(bp, x, cfg, policy, path, di, lengths=plan.lengths)
            T.write_rows(cache.h[ri], plan, nh)
            T.write_rows(cache.conv[ri], plan, tail_value(cache.conv, nc))
        else:
            x, (k, v) = attn_block_apply(bp, x, cfg, tp, policy, path, positions, di,
                                         return_kv=True)
            T._write_regions(cache, g, plan, k, v)
    T.write_lengths(cache, plan)
    return cache


def hybrid_decode_step(params, cfg: ArchConfig, policy: ApproxPolicy, cache: HybridCache,
                       tokens: Tensor, tp: int = 1, degree=None, active=None):
    """tokens: (B, 1).  One step over every slot: each recurrent block's
    state and conv tail advanced in place, each attention block's token
    K/V written into its ring (``flash_decode`` over the window).  Returns
    (logits (B, 1, V) f32, the cache with ``length + 1``).  ``active`` (B,)
    bool: the free-slot mask of the attention kernel."""
    gdeg, tdeg, hdeg = _group_degrees(degree, cfg, tokens.device)
    cfg_l = _local(cfg)
    x = L.embed_apply(params["embed"], tokens, T._dtype(cfg))
    for g, name, bp, ri, site in _blocks(params, cfg):
        path, di = ("tail" if g is None else "g"), _degree_of(gdeg, tdeg, g, site)
        if name == "rec":
            x, (nh, nc) = rec_block_apply(bp, x, cfg, policy, path, di,
                                          state=(cache.h[ri], cache.conv[ri]))
            cache.h[ri].copy_(nh)
            cache.conv[ri].copy_(nc)
        else:
            x = T.decode_block(bp, x, attn.KVCache(cache.k[g], cache.v[g], cache.length),
                               cfg_l, tp, policy, "g", di, active)
    tail_decoded(cache.conv)
    return T._head(params, cfg, policy, x, hdeg), cache._replace(length=cache.length + 1)
