"""Decoder / encoder transformer LM (dense, MoE, VLM and audio families),
config-driven, in PyTorch.

Layer parameters are stacked along a leading (n_layers, ...) axis as in the
reference; its layer ``scan`` is a Python loop over the stack here.  All
matmuls dispatch through the approximation layer, attention through
``kernels/dispatch.py``.  An MoE config replaces each block's gated MLP
with :mod:`repro_torch.models.moe`, added to the residual stream.

The frontends are the reference's stubs (:func:`embed_inputs`): the VLM
projects precomputed patch embeddings (``v_proj``: fc1, gelu, fc2) and
prepends them to the token embeddings; the audio encoder projects
precomputed frame features (``a_proj``: fc1) and adds sinusoidal positions.
Both projections run at the head site's degree.  The audio arch is
encoder-only (``causal=False``: non-causal ``dense`` attention, no rope)
and has no decode step; the VLM serves text-only prompts, as the reference
does.

The KV cache is updated in place by prefill and decode (the functional
reference returns fresh caches): the cache is the largest serving tensor,
and each entry point returns the same cache object with its new length.
Two cache types: :class:`LMCache` (bf16/f32) and :class:`LMCacheQ` (int8
codes with per-(token, head) f32 scales).

Prefill entry points: :func:`lm_prefill` (one prompt at its exact length),
:func:`lm_prefill_batch` (bucketed/packed rows padded to one length) and
:func:`lm_prefill_chunk` (one chunk of a long prompt, interleaved with
decode; bf16/f32 cache only).  MoE configs take :func:`lm_prefill` only:
capacity routing couples the rows of one call, so a padded or packed
prefill would not equal the exact-length one (the reference's rule).

Tensor parallelism (serving): on a mesh whose ``model`` axis is ``tp`` > 1
(``dist/meshctx.py``) every entry point takes this rank's shards
(``dist/sharding.py``) and its local cache, the reference's shard points
made explicit.  wq/wk/wv, up and gate are column-parallel: H/tp query heads
and KVr/tp repeated kv heads a rank (when tp does not divide the kv heads,
the wk/wv columns are all-gathered and each rank takes its repeated
heads).  wo and down are row-parallel (``approx_matmul`` all-reduces their
f32 partials, then adds bias and residual once).  The embedding is
vocab-parallel, and the logits the entry points return are this rank's
vocab columns, as the reference's are sharded over ``model``: callers that
need whole rows gather them (``layers.gather_vocab``).  tp = 1 keeps the
one-device route unchanged.  The SSM and hybrid families serve there too
(``models/ssm.py``, ``models/rglru.py``); the audio encoder, which has no
decode step, raises (:func:`check_tp_supported`, at the serving entry
points).

Training on a mesh (``(data, model)``, one process a rank): the dense
family's :func:`lm_forward` / :func:`lm_loss` run on this rank's shards
and rows, with the collectives that carry gradients
(``collectives.reduce_from_model`` for the embedding and the row-parallel
partials, ``layers.column_input`` on the three normed inputs of
column-parallel projections, ``collectives.gather_kv_heads`` for the
kv-split path) and the vocab-parallel cross-entropy
(``layers.vocab_parallel_ce``): the loss is this rank's masked
log-likelihood sum over the global token count, so the data ranks' losses
and gradients sum to the reference's masked mean.  The MoE family trains
there through ``moe.moe_apply``'s expert-parallel block (capacity and the
aux loss per data shard, as the reference's shard_map computes them), and
the frontends gather their column-parallel weights whole
(:func:`embed_inputs`).  The SSM and hybrid families train there through
their own forwards and the same loss (:func:`lm_loss`'s ``forward``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.approx import ApproxPolicy
from repro_torch.dist import collectives, meshctx
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.qstore import PackedEmulWeight, PackedQWeight
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models.cache_ops import cache_reset_slot, ring_write_indices
from repro_torch.models.degrees import split_degree

Tensor = torch.Tensor


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


#: the frontend each family carries (None: token embeddings only)
FAMILY_FRONTENDS = {"dense": None, "moe": None, "ssm": None, "hybrid": None,
                    "vlm": "vision", "audio": "audio"}


def check_supported(cfg: ArchConfig) -> None:
    """The port covers the dense, MoE, SSM and hybrid families and the
    frontend archs (VLM with the vision stub, audio with the frame stub)."""
    if (cfg.family not in FAMILY_FRONTENDS or bool(cfg.moe) != (cfg.family == "moe")
            or cfg.frontend != FAMILY_FRONTENDS[cfg.family]):
        raise NotImplementedError(
            f"{cfg.name!r} ({cfg.family}, frontend {cfg.frontend}) is not ported; the "
            "dense, MoE, SSM, hybrid, VLM (vision) and audio families are")


def check_tp_supported(cfg: ArchConfig, tp: int) -> None:
    """Tensor-parallel serving covers every family with a decode step; tp
    above 1 raises for the audio encoder, which has none."""
    if tp > 1 and cfg.encoder_only:
        raise NotImplementedError(
            f"{cfg.name} at tp={tp}: the audio encoder has no decode step to serve; "
            "tensor parallelism for it is ROADMAP §A")


def tp_heads(cfg: ArchConfig, tp: int) -> tuple:
    """(query heads, repeated kv heads) this rank computes: the padded
    counts, over the active mesh's ``model`` axis (which must be ``tp``
    when it is wider than 1)."""
    pd = cfg.padded(tp)
    m = meshctx.model_size()
    if m == 1:
        return pd.n_heads, pd.n_kv_rep
    if tp != m:
        raise ValueError(f"tp={tp} on a mesh whose model axis is {m}")
    if pd.n_heads % m or pd.n_kv_rep % m:
        raise ValueError(f"{cfg.name}: {pd.n_heads} heads / {pd.n_kv_rep} kv heads do "
                         f"not split over tp={m}")
    return pd.n_heads // m, pd.n_kv_rep // m


def attn_window(cfg: ArchConfig):
    """The window of a family's attention blocks: the hybrid's local
    window, else ``swa_window`` (None: full attention)."""
    return cfg.local_window if cfg.family == "hybrid" else cfg.swa_window


def _no_moe(cfg: ArchConfig, what: str) -> None:
    if cfg.moe:
        raise ValueError(f"{what} is exact-length only for MoE ({cfg.name}): capacity "
                         "routing couples the rows of one call")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ArchConfig, tp: int = 1, stack: tuple = (),
               device="cpu"):
    """One attention block's parameters (``stack`` prepends leading dims:
    stacked layers, one draw each): truncated normal at ±2σ."""
    pd = cfg.padded(tp)
    d, D, H = cfg.d_model, cfg.head_dim, pd.n_heads
    p = {
        "ln1": L.init_rmsnorm(d, stack, device),
        "ln2": L.init_rmsnorm(d, stack, device),
        "wq": L.init_dense(gen, d, H * D, bias=cfg.qkv_bias, stack=stack, device=device),
        "wk": L.init_dense(gen, d, cfg.n_kv_heads * D, bias=cfg.qkv_bias,
                           stack=stack, device=device),
        "wv": L.init_dense(gen, d, cfg.n_kv_heads * D, bias=cfg.qkv_bias,
                           stack=stack, device=device),
        "wo": L.init_dense(gen, H * D, d, scale=1.0 / math.sqrt(H * D),
                           stack=stack, device=device),
    }
    if cfg.moe:
        p["moe"] = moe_mod.init_moe(gen, cfg, tp, stack, device)
    else:
        p["mlp"] = L.init_gated_mlp(gen, d, cfg.d_ff, stack, device)
    return p


def init_lm(gen: torch.Generator, cfg: ArchConfig, tp: int = 1, device="cpu"):
    """Random-init parameters, every layer's weights stacked along a
    leading (n_layers,) axis."""
    check_supported(cfg)
    d, pd = cfg.d_model, cfg.padded(tp)
    layers = init_block(gen, cfg, tp, (cfg.n_layers,), device)
    params = {
        "embed": L.init_embedding(gen, pd.vocab, d, device),
        "layers": layers,
        "ln_f": L.init_rmsnorm(d, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_dense(gen, d, pd.vocab,
                                         scale=1.0 / math.sqrt(d), device=device)
    if cfg.frontend == "vision":
        params["v_proj"] = {
            "fc1": L.init_dense(gen, cfg.frontend_dim, d, bias=True, device=device),
            "fc2": L.init_dense(gen, d, d, bias=True, device=device),
        }
    elif cfg.frontend == "audio":
        params["a_proj"] = {
            "fc1": L.init_dense(gen, cfg.frontend_dim, d, bias=True, device=device)}
    return params


def layer_params(layers, i: int):
    """Layer ``i``'s slice of the stacked layer tree (views, no copies)."""
    if isinstance(layers, PackedQWeight):
        return PackedQWeight(layers.qw[i], layers.scales[i])
    if isinstance(layers, PackedEmulWeight):
        return PackedEmulWeight(layers.qw[i], layers.scale[i])
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------


def _qkv(bp, x, cfg: ArchConfig, tp: int, policy, path, positions, degree):
    """(q, k, v) of this rank's heads: (B, S, H, D) and (B, S, KVr, D)."""
    B, S, _ = x.shape
    (H, KVr), D = tp_heads(cfg, tp), cfg.head_dim
    q = L.dense_apply(bp["wq"], x, policy, path + "/wq", degree).reshape(B, S, H, D)
    k = L.dense_apply(bp["wk"], x, policy, path + "/wk", degree)
    v = L.dense_apply(bp["wv"], x, policy, path + "/wv", degree)
    mesh = meshctx.get_mesh()
    m = mesh.size("model")
    # tp does not divide the kv heads: a rank's wk/wv columns cut a head,
    # so gather every kv head and take this rank's repeated ones
    split = m > 1 and cfg.n_kv_heads % m != 0
    if split:
        k = collectives.gather_kv_heads(k, mesh.group("model"))
        v = collectives.gather_kv_heads(v, mesh.group("model"))
    kvh = cfg.n_kv_heads // m if m > 1 and not split else cfg.n_kv_heads
    k = k.reshape(B, S, kvh, D)
    v = v.reshape(B, S, kvh, D)
    if cfg.rope_theta and cfg.causal:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    if split:
        first = mesh.coord("model") * KVr
        return (q, attn.repeat_kv(k, KVr * m).narrow(2, first, KVr),
                attn.repeat_kv(v, KVr * m).narrow(2, first, KVr))
    return q, attn.repeat_kv(k, KVr), attn.repeat_kv(v, KVr)


def _ffn(bp, h: Tensor, x: Tensor, cfg: ArchConfig, policy: ApproxPolicy, path: str,
         degree):
    """The block's second half on the normed ``h``, added to the residual
    ``x``: the gated MLP (the add fused in its down projection) or the MoE
    block.  Returns (out, aux loss or None)."""
    if cfg.moe:
        f, aux = moe_mod.moe_apply(bp["moe"], h, cfg, policy, path + "/moe", degree)
        return x + f, aux
    h = L.column_input(h, policy, (path + "/mlp/up", path + "/mlp/gate"))
    return L.gated_mlp_apply(bp["mlp"], h, policy, path + "/mlp", cfg.act, degree,
                             residual=x), None


def block_apply(bp, x: Tensor, cfg: ArchConfig, tp: int, policy: ApproxPolicy,
                path: str, positions: Tensor, degree=None,
                return_kv: bool = False, return_aux: bool = False):
    """One block's forward; with ``return_kv`` also the post-rope (k, v)
    that prefill writes into a slot's cache region; with ``return_aux``
    (out, the MoE aux load-balance loss, None for a dense block) instead."""
    h = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
    h = L.column_input(h, policy, (path + "/wq", path + "/wk", path + "/wv"))
    q, k, v = _qkv(bp, h, cfg, tp, policy, path, positions, degree)
    o = kdispatch.prefill_attention(q, k, v, causal=cfg.causal,
                                    window=cfg.swa_window)
    o = o.reshape(x.shape[0], x.shape[1], q.shape[2] * cfg.head_dim)
    # residual adds ride the projection epilogues (fused in-kernel on AXQ)
    x = L.dense_apply(bp["wo"], o, policy, path + "/wo", degree, residual=x)
    h = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    out, aux = _ffn(bp, h, x, cfg, policy, path, degree)
    if return_aux:
        return out, aux
    return (out, (k, v)) if return_kv else out


def _head(params, cfg, policy, x, hdeg) -> Tensor:
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    x = L.column_input(x, policy, ("unembed",))
    if cfg.tie_embeddings:
        return L.unembed_apply(params["embed"], x, policy, "unembed", hdeg)
    return L.dense_apply(params["unembed"], x, policy, "unembed", hdeg).to(torch.float32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


REMAT = ("none", "dots", "full")


def remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the ``remat`` policy of a layer (or group) body:
    ``none`` keeps its activations for the backward; ``dots`` and ``full``
    both recompute the whole body in the backward
    (``torch.utils.checkpoint.checkpoint``, non-reentrant).  The reference's
    ``dots`` keeps the matmul outputs and recomputes the rest; here the
    projections are ``torch.autograd.Function``s (the kernel forwards) whose
    outputs a selective-checkpoint policy cannot pick out, so ``dots``
    takes ``full``'s schedule.  A saving policy changes memory and
    recompute time, never a value: every op recomputes bit for bit (the
    kernels are deterministic).  Without autograd recording (serving,
    ``torch.no_grad``) the body just runs."""
    if remat not in REMAT:
        raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False)


def _sinusoidal(S: int, d: int, device=None) -> Tensor:
    """(S, d) f32 absolute positions, ``[sin | cos]`` halves (not
    interleaved), frequencies ``10000^(-2i/d)``."""
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10_000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _frontend_layer(p: dict) -> dict:
    """A frontend projection with its weight whole: this rank's columns
    gathered over ``model`` on a mesh (:func:`embed_inputs`), else ``p``."""
    mesh = meshctx.get_mesh()
    if mesh.size("model") == 1:
        return p
    return {**p, "w": collectives.gather_from_model(p["w"], mesh.group("model"), dim=-1)}


def embed_inputs(params, cfg: ArchConfig, batch: dict, dtype, policy: ApproxPolicy,
                 degree) -> tuple[Tensor, Tensor]:
    """The token embeddings, with the frontend stubs: audio frames through
    ``a_proj/fc1`` plus sinusoidal positions (computed in f32, cast to
    ``dtype``); image patches through ``v_proj`` (fc1, gelu, fc2) prepended
    to the tokens.  ``degree`` is the head site's (the frontends share
    it).  Returns (x (B, S, d), positions (B, S) int32).

    On a ``model`` axis wider than 1 (training) the frontends' weights are
    this rank's columns (column-parallel by the name rules; their biases
    replicated): each weight is gathered whole first
    (``collectives.gather_from_model``, whose backward keeps this rank's
    slice of the cotangent, the same on every rank), so the frontend's
    output is whole and replicated before the blocks."""
    if cfg.frontend == "audio":
        fe = batch["frame_feats"].to(dtype)                       # (B, S, frontend_dim)
        x = L.dense_apply(_frontend_layer(params["a_proj"]["fc1"]), fe, policy, "a_proj/fc1",
                          degree)
        x = x + _sinusoidal(x.shape[1], x.shape[2], x.device).to(dtype)[None]
    else:
        x = L.embed_apply(params["embed"], batch["tokens"], dtype)
        if cfg.frontend == "vision":
            vp = params["v_proj"]
            pe = batch["patch_embeds"].to(dtype)                  # (B, S_img, frontend_dim)
            h = L.dense_apply(_frontend_layer(vp["fc1"]), pe, policy, "v_proj/fc1", degree)
            # jax.nn.gelu's tanh form, each op rounded as the reference's
            h = L.act_rounded("gelu")(h)
            h = L.dense_apply(_frontend_layer(vp["fc2"]), h, policy, "v_proj/fc2", degree)
            x = torch.cat([h, x], dim=1)
    B, S = x.shape[:2]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return x, positions


def lm_forward(params, cfg: ArchConfig, policy: ApproxPolicy, batch: dict,
               tp: int = 1, degree=None, remat: str = "dots") -> tuple[Tensor, Tensor]:
    """Returns (logits (B, S, vocab_padded) f32, the layers' summed aux
    load-balance loss (0 for a dense model)); S counts a VLM's image
    tokens.  ``remat`` is the layers' activation policy under autograd
    (:func:`remat_call`).  On a mesh: this rank's rows and vocab columns,
    and the aux loss of this rank's rows."""
    dev = next(iter(batch.values())).device
    ldeg, hdeg = split_degree(degree, cfg.n_layers, dev)
    x, positions = embed_inputs(params, cfg, batch, _dtype(cfg), policy, hdeg)
    aux = torch.zeros((), dtype=torch.float32, device=dev)

    def body(bp, h, dg):
        return block_apply(bp, h, cfg, tp, policy, "layer", positions, dg, return_aux=True)

    for i in range(cfg.n_layers):
        x, a = remat_call(remat, body, layer_params(params["layers"], i), x,
                          None if ldeg is None else ldeg[i])
        if a is not None:
            aux = aux + a
    return _head(params, cfg, policy, x, hdeg), aux


def lm_loss(params, cfg: ArchConfig, policy: ApproxPolicy, batch: dict,
            tp: int = 1, degree=None, remat: str = "dots",
            forward=None) -> tuple[Tensor, dict]:
    """Masked next-token cross-entropy over ``labels >= 0`` (a VLM's text
    positions only) plus 0.01 x the aux load-balance loss of ``forward``
    (default :func:`lm_forward`; the SSM and hybrid families pass theirs,
    whose aux loss is a zero, so their loss is the cross-entropy).  Returns (loss,
    {"ce", "aux", "ntokens"}), all device scalars.  On a mesh the loss and
    ``ce`` are this rank's share: its rows' log-likelihood sum over the
    token count of every data rank (``ntokens``, all-reduced over
    ``data``), so the data ranks' shares sum to the masked mean; the loss
    carries ``0.01 x aux / dp`` of this rank's rows' aux loss, so the
    shares sum to the reference's mean of the data shards' aux (its
    ``pmean``).  ``aux`` is this rank's (``train.step`` averages it over
    ``data``)."""
    logits, aux = (forward or lm_forward)(params, cfg, policy, batch, tp, degree, remat)
    labels = batch["labels"]
    if cfg.frontend == "vision":
        # the logits cover [image tokens | text tokens]: the loss is the text's
        logits = logits[:, -labels.shape[1]:]
    llsum, ntok = L.vocab_parallel_ce(logits, labels)
    mesh = meshctx.get_mesh()
    ntok = collectives.all_reduce(ntok, meshctx.data_group(mesh))
    ce = -llsum / torch.clamp(ntok, min=1.0)
    dp = math.prod(mesh.size(a) for a in meshctx.batch_axes(mesh))
    loss = ce + 0.01 * aux / dp
    return loss, {"ce": ce, "aux": aux, "ntokens": ntok}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class LMCache(NamedTuple):
    k: Tensor       # (L, B, T, KVr, D)
    v: Tensor
    length: Tensor  # (B,) int32


class LMCacheQ(NamedTuple):
    """int8 cache stack."""

    k: Tensor       # (L, B, T, KVr, D) int8
    v: Tensor
    ks: Tensor      # (L, B, T, KVr) f32
    vs: Tensor
    length: Tensor  # (B,) int32


def init_lm_cache(cfg: ArchConfig, tp: int, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu", quant: bool = False):
    """A zeroed cache of this rank's kv heads (all of them on one device)."""
    T = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    shape = (cfg.n_layers, batch, T, tp_heads(cfg, tp)[1], cfg.head_dim)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if quant:
        return LMCacheQ(torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.zeros(shape[:4], dtype=torch.float32, device=device),
                        torch.zeros(shape[:4], dtype=torch.float32, device=device),
                        length)
    return LMCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), length)


def _layer_cache(cache, i: int):
    """Layer ``i``'s per-layer view of the stacked cache (no copies)."""
    if isinstance(cache, LMCacheQ):
        return attn.QuantKVCache(cache.k[i], cache.v[i], cache.ks[i], cache.vs[i],
                                 cache.length)
    return attn.KVCache(cache.k[i], cache.v[i], cache.length)


def _write_kv(cache, i: int, slot, dst, k: Tensor, v: Tensor) -> None:
    """Write K/V rows ``k``/``v`` (..., KVr, D) into layer ``i`` at
    ``[slot, dst]`` (index tensors or ints), in place; the int8 cache stores
    their codes and scales."""
    if isinstance(cache, LMCacheQ):
        kq, ksc = attn._q8(k)
        vq, vsc = attn._q8(v)
        cache.k[i, slot, dst] = kq
        cache.v[i, slot, dst] = vq
        cache.ks[i, slot, dst] = ksc
        cache.vs[i, slot, dst] = vsc
    else:
        cache.k[i, slot, dst] = k.to(cache.k.dtype)
        cache.v[i, slot, dst] = v.to(cache.v.dtype)


def lm_prefill(params, cfg: ArchConfig, policy: ApproxPolicy, cache,
               tokens: Tensor, slot, tp: int = 1, degree=None):
    """Fused prefill: run the whole prompt through one forward pass and
    write its KV into ``slot``'s cache region (positions ``0..P-1``,
    ring-wrapped for sliding-window caches), in place; the region is reset
    first, so a reused slot equals a fresh one.

    tokens: (P,) int, P >= 1.  Returns (last-position logits (1, V) f32,
    the cache with ``length[slot] = P``)."""
    ldeg, hdeg = split_degree(degree, cfg.n_layers, tokens.device)
    P = tokens.shape[0]
    T = cache.k.shape[2]
    ring = cfg.swa_window is not None and cfg.swa_window <= T
    if P > T and not ring:
        raise ValueError(f"prompt ({P}) exceeds cache capacity ({T})")
    cache_reset_slot(cache, slot)
    x = L.embed_apply(params["embed"], tokens[None], _dtype(cfg))     # (1, P, d)
    positions = torch.arange(P, dtype=torch.int32, device=tokens.device)[None]
    src, dst = ring_write_indices(P, T, tokens.device)
    for i in range(cfg.n_layers):
        x, (k, v) = block_apply(layer_params(params["layers"], i), x, cfg, tp,
                                policy, "layer", positions,
                                None if ldeg is None else ldeg[i], return_kv=True)
        _write_kv(cache, i, slot, dst, k[0, src], v[0, src])
    cache.length[slot] = P
    logits = _head(params, cfg, policy, x[:, -1:], hdeg)
    return logits.to(torch.float32)[:, 0], cache


class BatchWritePlan(NamedTuple):
    """The cache writes of a bucketed prefill, as fixed-shape device
    tensors (no host read): ring position ``t`` of row ``r`` takes the
    row's token ``src[r, t]`` where ``valid[r, t]``, else zero; each row
    writes slot ``target[r]`` — its own slot for a live row; for a dummy
    row a slot no live row of its group writes, given back its old
    values."""

    live: Tensor      # (N,) bool: 0 <= slot < B
    lengths: Tensor   # (N,) int32, 0 on dummy rows
    src: Tensor       # (N, T) int64
    valid: Tensor     # (N, T) bool
    target: Tensor    # (N,) int64


def _row_groups(N: int, B: int) -> list:
    """Row ranges of at most ``B`` rows: the rows of one group write
    distinct slots."""
    return [(r, min(r + B, N)) for r in range(0, N, B)]


def _row_targets(slots: Tensor, live: Tensor, B: int) -> Tensor:
    """The slot each row of one group (at most B rows, distinct live slots)
    writes: a live row its own; the k-th dummy row the k-th slot, in
    order, that no live row of the group writes."""
    used = torch.zeros((B + 1,), dtype=torch.bool, device=slots.device)
    used.index_fill_(0, torch.where(live, slots, B), True)
    free = torch.argsort(used[:B].to(torch.int32), stable=True)
    rank = torch.cumsum((~live).to(torch.int64), 0) - 1
    return torch.where(live, slots, free[torch.clamp(rank, 0, B - 1)])


def _batch_write_plan(slots: Tensor, lengths: Tensor, B: int, T: int,
                      Pb: int) -> BatchWritePlan:
    """Device-side index plan of a bucketed prefill's cache writes, made
    destination first: each live row keeps the last ``min(length, T)`` of
    its ``length`` real tokens, token ``j`` at ring position ``j % T`` —
    for ring position ``t`` the newest ``j < length`` with ``j % T == t``,
    so every cache position is written once.  Dummy rows (``slot`` outside
    ``[0, B)``) and pad positions write nothing new: the reference drops
    them as out-of-bounds scatters, which a fixed-shape write cannot, so a
    dummy row rewrites a slot no live row touches with its own bits.
    ``slots``/``lengths``: (N,) int64 device tensors."""
    live = (slots >= 0) & (slots < B)
    n = torch.where(live, lengths, 0)
    t = torch.arange(T, dtype=torch.int64, device=slots.device)
    last = n[:, None] - 1                                          # (N, 1)
    j = last - torch.remainder(last - t[None], T)                  # (N, T)
    valid = (j >= 0) & live[:, None]
    src = torch.clamp(j, 0, Pb - 1)
    target = torch.cat([_row_targets(slots[r0:r1], live[r0:r1], B)
                        for r0, r1 in _row_groups(slots.shape[0], B)])
    return BatchWritePlan(live, n.to(torch.int32), src, valid, target)


def _write_regions(cache, i: int, plan: BatchWritePlan, k: Tensor, v: Tensor) -> None:
    """Write layer ``i``'s slot regions of a bucketed prefill (``k``/``v``
    (N, Pb, KVr, D)) by ``plan``, in place: each row's whole region (its
    tokens, zeros elsewhere — the reset), a dummy row its target's old
    region.  The int8 cache stores codes and scales (:func:`attn._q8`, per
    token and head, so quantizing before the gather is bit-identical)."""
    if isinstance(cache, LMCacheQ):
        kq, ksc = attn._q8(k)
        vq, vsc = attn._q8(v)
        fields = ((cache.k, kq), (cache.v, vq), (cache.ks, ksc), (cache.vs, vsc))
    else:
        fields = ((cache.k, k), (cache.v, v))
    N = k.shape[0]
    for r0, r1 in _row_groups(N, cache.k.shape[1]):
        tgt, live = plan.target[r0:r1], plan.live[r0:r1]
        src, valid = plan.src[r0:r1], plan.valid[r0:r1]
        rows = torch.arange(r1 - r0, device=k.device)[:, None]
        for dst, x in fields:
            layer = dst[i]                                         # (B, T, ...)
            tail = (1,) * (x.dim() - 2)
            new = torch.where(valid.reshape(*valid.shape, *tail),
                              x[r0:r1][rows, src].to(layer.dtype), 0)
            old = layer.index_select(0, tgt)
            layer.index_copy_(0, tgt, torch.where(live.reshape(-1, 1, *tail), new, old))


def lm_prefill_batch(params, cfg: ArchConfig, policy: ApproxPolicy, cache,
                     tokens: Tensor, slots, lengths, tp: int = 1, degree=None):
    """Bucketed/packed prefill: ``tokens`` (N, Pb) — N prompt rows padded to
    one bucket length Pb — written into ``slots`` (N,) with true lengths
    ``lengths`` (N,), in place; each live row's slot region is reset (its
    whole region is written).  ``slots``/``lengths`` are int tensors on the
    tokens' device — then nothing is read on the host and the call can be
    captured in a CUDA graph — or host integers (a list or numpy), whose
    lengths are checked against the bucket first.

    Per-row results equal :func:`lm_prefill` at the exact length: every op
    below attention is position-local, and causal attention over a padded
    suffix leaves the prefix rows untouched.  Rows may be dummies: a row
    with ``slot`` outside ``[0, B)`` writes nothing (live slots must be
    distinct), a row with ``length == 0`` only resets its slot.  Returns
    the cache (no logits — admission feeds the last prompt token through
    decode)."""
    _no_moe(cfg, "bucketed prefill")
    ldeg, _ = split_degree(degree, cfg.n_layers, tokens.device)
    N, Pb = tokens.shape
    B, T = cache.k.shape[1], cache.k.shape[2]
    ring = cfg.swa_window is not None and cfg.swa_window <= T
    if Pb > T and not ring:
        raise ValueError(f"bucket ({Pb}) exceeds cache capacity ({T})")
    plan = state_write_plan(tokens, slots, lengths, B, T)
    x = L.embed_apply(params["embed"], tokens, _dtype(cfg))          # (N, Pb, d)
    positions = torch.arange(Pb, dtype=torch.int32, device=tokens.device)[None].expand(N, Pb)
    for i in range(cfg.n_layers):
        x, (k, v) = block_apply(layer_params(params["layers"], i), x, cfg, tp,
                                policy, "layer", positions,
                                None if ldeg is None else ldeg[i], return_kv=True)
        _write_regions(cache, i, plan, k, v)
    write_lengths(cache, plan)
    return cache


def state_write_plan(tokens: Tensor, slots, lengths, B: int, T: int = 1) -> BatchWritePlan:
    """The write plan of a bucketed prefill of ``tokens`` (N, Pb) into a
    cache of ``B`` slots (and ring positions ``T``: the KV rows; 1 for a
    cache of per-slot states alone).  ``slots`` / ``lengths``: int device
    tensors (nothing read on the host) or host integers, whose lengths are
    checked against the bucket first."""
    N, Pb = tokens.shape
    dev = tokens.device
    if not isinstance(lengths, Tensor):
        hs = np.asarray(slots).reshape(-1)
        for r, (s, n) in enumerate(zip(hs, np.asarray(lengths).reshape(-1))):
            if 0 <= s < B and n > Pb:
                raise ValueError(f"row {r}: length {n} exceeds the bucket ({Pb})")
    slots = torch.as_tensor(slots, dtype=torch.int64).to(dev).reshape(N)
    lengths = torch.as_tensor(lengths, dtype=torch.int64).to(dev).reshape(N)
    return _batch_write_plan(slots, lengths, B, T, Pb)


def write_rows(field: Tensor, plan: BatchWritePlan, new: Tensor) -> None:
    """Write a bucketed prefill's per-row states ``new`` (N, ...) into
    ``field`` (B, ...), slot axis first, by ``plan``, in place: each live
    row into its slot, a dummy row its target's old values back."""
    tail = (1,) * (field.dim() - 1)
    for r0, r1 in _row_groups(new.shape[0], field.shape[0]):
        tgt = plan.target[r0:r1]
        old = field.index_select(0, tgt)
        field.index_copy_(0, tgt, torch.where(plan.live[r0:r1].reshape(-1, *tail),
                                              new[r0:r1].to(field.dtype), old))


def write_lengths(cache, plan: BatchWritePlan) -> None:
    """Set each live row's slot length of a bucketed prefill, in place."""
    B = cache.length.shape[0]
    for r0, r1 in _row_groups(plan.live.shape[0], B):
        tgt = plan.target[r0:r1]
        cache.length.index_copy_(0, tgt, torch.where(
            plan.live[r0:r1], plan.lengths[r0:r1], cache.length.index_select(0, tgt)))


def _chunk_rows(layer: Tensor, rows: Tensor, write: Tensor, new: Tensor) -> None:
    """Write ``new`` (C, KVr, D) into ``layer`` (B, T, KVr, D) at the flat
    (slot, position) ``rows`` (C,) where ``write``, in place; the other
    rows are given back their old values."""
    flat = layer.view(layer.shape[0] * layer.shape[1], *layer.shape[2:])
    old = flat.index_select(0, rows)
    flat.index_copy_(0, rows, torch.where(write[:, None, None], new.to(layer.dtype), old))


def lm_prefill_chunk(params, cfg: ArchConfig, policy: ApproxPolicy,
                     cache: LMCache, tokens: Tensor, slot, offset, clen,
                     tp: int = 1, degree=None) -> LMCache:
    """Incremental prefill of one chunk: ``tokens`` (C,) continues ``slot``'s
    prompt at position ``offset``, with ``clen <= C`` real tokens (ints or
    int device scalars: as device scalars nothing is read on the host and
    the call can be captured in a CUDA graph).  The chunk's K/V is written
    at ``offset + j`` for ``j < clen`` (positions past the cache are
    dropped) and each chunk position attends over the slot's cache rows up
    to its own position — so long prompts can be admitted across ticks,
    interleaved with decode.  Dense full-attention bf16/f32 caches only;
    the adapter gates eligibility.  A ``slot`` outside the cache (a
    warm-up dummy) writes nothing: its rows are given back their old
    values and its attention, over another slot's rows, is discarded.  The
    attention is plain PyTorch, as the reference's is jnp: deterministic,
    but not bit-exact against one-shot prefill (cache precision, T-length
    reductions).  Sets ``length[slot] = offset + clen``; returns the
    cache."""
    _no_moe(cfg, "chunked prefill")
    ldeg, _ = split_degree(degree, cfg.n_layers, tokens.device)
    C = tokens.shape[0]
    B, T, kvh = cache.k.shape[1], cache.k.shape[2], cache.k.shape[3]
    if C > T:
        raise ValueError(f"chunk ({C}) exceeds cache capacity ({T})")
    dev = tokens.device
    slot, offset, clen = (torch.as_tensor(a, dtype=torch.int64).to(dev)
                          for a in (slot, offset, clen))
    live = (slot >= 0) & (slot < B)
    sc = torch.clamp(slot, 0, B - 1).reshape(1)
    j = torch.arange(C, dtype=torch.int64, device=dev)
    pos = offset + j                                                  # (C,)
    write = (j < clen) & (pos < T) & live
    rows = sc * T + torch.remainder(pos, T)            # distinct: C <= T
    x = L.embed_apply(params["embed"], tokens[None], _dtype(cfg))     # (1, C, d)
    positions = pos.to(torch.int32)[None]                             # (1, C)
    qmask = torch.arange(T, device=dev)[None, :] <= pos[:, None]      # (C, T)
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        dg = None if ldeg is None else ldeg[i]
        hn = L.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        q, k, v = _qkv(lp, hn, cfg, tp, policy, "layer", positions, dg)
        _chunk_rows(cache.k[i], rows, write, k[0])
        _chunk_rows(cache.v[i], rows, write, v[0])
        keys = cache.k[i].index_select(0, sc)[0]                      # (T, KVr, D)
        vals = cache.v[i].index_select(0, sc)[0]
        qg = attn._group_q(q, kvh)                                    # (1, C, KV, G, D)
        s = torch.einsum("bqkgd,tkd->bkgqt", qg.to(torch.float32),
                         keys.to(torch.float32)) / math.sqrt(cfg.head_dim)
        s = torch.where(qmask[None, None, None], s, attn.NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqt,tkd->bqkgd", p, vals.to(torch.float32))
        o = o.reshape(1, C, q.shape[2] * cfg.head_dim).to(x.dtype)
        x = L.dense_apply(lp["wo"], o, policy, "layer/wo", dg, residual=x)
        hn = L.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps)
        x = L.gated_mlp_apply(lp["mlp"], hn, policy, "layer/mlp", cfg.act,
                              dg, residual=x)
    cache.length.index_copy_(0, sc, torch.where(
        live, (offset + clen).to(torch.int32), cache.length.index_select(0, sc)))
    return cache


def lm_decode_step(params, cfg: ArchConfig, policy: ApproxPolicy, cache,
                   tokens: Tensor, tp: int = 1, degree=None, active=None):
    """tokens: (B, 1).  One decode step over every slot; the new token's K/V
    (its int8 codes and scales for an :class:`LMCacheQ`) is written into the
    cache in place.  Returns (logits (B, 1, V) f32, the cache with
    ``length + 1``).  ``active`` (B,) bool: free-slot mask for the attention
    kernel.  On a mesh the logits are this rank's vocab columns (module
    docstring)."""
    ldeg, hdeg = split_degree(degree, cfg.n_layers, tokens.device)
    x = L.embed_apply(params["embed"], tokens, _dtype(cfg))
    for i in range(cfg.n_layers):
        x = decode_block(layer_params(params["layers"], i), x, _layer_cache(cache, i), cfg,
                         tp, policy, "layer", None if ldeg is None else ldeg[i], active)
    logits = _head(params, cfg, policy, x, hdeg)
    return logits, cache._replace(length=cache.length + 1)


def decode_block(bp, x: Tensor, layer_cache, cfg: ArchConfig, tp: int,
                 policy: ApproxPolicy, path: str, degree=None, active=None) -> Tensor:
    """One attention block's decode step on x (B, 1, d): the token's K/V
    written into ``layer_cache`` (one layer's KV cache, at the positions
    its ``length`` gives) in place, attention over ``cfg.swa_window``.
    Returns the block's output."""
    B = x.shape[0]
    hn = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(bp, hn, cfg, tp, policy, path, layer_cache.length[:, None], degree)
    o, _ = kdispatch.decode_attention(q, k, v, layer_cache, window=cfg.swa_window,
                                      degree=degree, active=active)
    o = o.reshape(B, 1, q.shape[2] * cfg.head_dim)
    x = L.dense_apply(bp["wo"], o, policy, path + "/wo", degree, residual=x)
    hn = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    return _ffn(bp, hn, x, cfg, policy, path, degree)[0]
