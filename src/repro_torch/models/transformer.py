"""Decoder transformer LM (dense family), config-driven, in PyTorch.

Layer parameters are stacked along a leading (n_layers, ...) axis as in the
reference; its layer ``scan`` is a Python loop over the stack here.  All
matmuls dispatch through the approximation layer, attention through
``kernels/dispatch.py``.

The KV cache is updated in place by prefill and decode (the functional
reference returns fresh caches): the cache is the largest serving tensor,
and each entry point returns the same cache object with its new length.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.approx import ApproxPolicy
from repro_torch.kernels import dispatch as kdispatch
from repro_torch.kernels.qstore import PackedQWeight
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.cache_ops import cache_reset_slot, ring_write_indices
from repro_torch.models.degrees import split_degree

Tensor = torch.Tensor


def _dtype(cfg: ArchConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def check_supported(cfg: ArchConfig) -> None:
    """The port covers the dense family (no MoE, no frontend) so far."""
    if cfg.family != "dense" or cfg.moe or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name!r} ({cfg.family}) is not ported; the dense family is")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_lm(gen: torch.Generator, cfg: ArchConfig, tp: int = 1, device="cpu"):
    """Random-init parameters: truncated normal at ±2σ, every layer's weights
    stacked along a leading (n_layers,) axis."""
    check_supported(cfg)
    pd = cfg.padded(tp)
    d, D, nl = cfg.d_model, cfg.head_dim, cfg.n_layers
    H = pd.n_heads
    st = (nl,)
    layers = {
        "ln1": L.init_rmsnorm(d, st, device),
        "ln2": L.init_rmsnorm(d, st, device),
        "wq": L.init_dense(gen, d, H * D, bias=cfg.qkv_bias, stack=st, device=device),
        "wk": L.init_dense(gen, d, cfg.n_kv_heads * D, bias=cfg.qkv_bias,
                           stack=st, device=device),
        "wv": L.init_dense(gen, d, cfg.n_kv_heads * D, bias=cfg.qkv_bias,
                           stack=st, device=device),
        "wo": L.init_dense(gen, H * D, d, scale=1.0 / math.sqrt(H * D),
                           stack=st, device=device),
        "mlp": L.init_gated_mlp(gen, d, cfg.d_ff, st, device),
    }
    params = {
        "embed": L.init_embedding(gen, pd.vocab, d, device),
        "layers": layers,
        "ln_f": L.init_rmsnorm(d, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.init_dense(gen, d, pd.vocab,
                                         scale=1.0 / math.sqrt(d), device=device)
    return params


def layer_params(layers, i: int):
    """Layer ``i``'s slice of the stacked layer tree (views, no copies)."""
    if isinstance(layers, PackedQWeight):
        return PackedQWeight(layers.qw[i], layers.scales[i])
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return layers[i]


# ---------------------------------------------------------------------------
# block apply
# ---------------------------------------------------------------------------


def _qkv(bp, x, cfg: ArchConfig, pd, policy, path, positions, degree):
    B, S, _ = x.shape
    H, KVr, D = pd.n_heads, pd.n_kv_rep, cfg.head_dim
    q = L.dense_apply(bp["wq"], x, policy, path + "/wq", degree).reshape(B, S, H, D)
    k = L.dense_apply(bp["wk"], x, policy, path + "/wk", degree).reshape(
        B, S, cfg.n_kv_heads, D)
    v = L.dense_apply(bp["wv"], x, policy, path + "/wv", degree).reshape(
        B, S, cfg.n_kv_heads, D)
    if cfg.rope_theta and cfg.causal:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    return q, attn.repeat_kv(k, KVr), attn.repeat_kv(v, KVr)


def block_apply(bp, x: Tensor, cfg: ArchConfig, tp: int, policy: ApproxPolicy,
                path: str, positions: Tensor, degree=None,
                return_kv: bool = False):
    """One block's forward; with ``return_kv`` also the post-rope (k, v)
    that prefill writes into a slot's cache region."""
    pd = cfg.padded(tp)
    h = L.rmsnorm_apply(bp["ln1"], x, cfg.norm_eps)
    q, k, v = _qkv(bp, h, cfg, pd, policy, path, positions, degree)
    o = kdispatch.prefill_attention(q, k, v, causal=cfg.causal,
                                    window=cfg.swa_window)
    o = o.reshape(x.shape[0], x.shape[1], pd.n_heads * cfg.head_dim)
    # residual adds ride the projection epilogues (fused in-kernel on AXQ)
    x = L.dense_apply(bp["wo"], o, policy, path + "/wo", degree, residual=x)
    h = L.rmsnorm_apply(bp["ln2"], x, cfg.norm_eps)
    out = L.gated_mlp_apply(bp["mlp"], h, policy, path + "/mlp", cfg.act,
                            degree, residual=x)
    return (out, (k, v)) if return_kv else out


def _head(params, cfg, policy, x, hdeg) -> Tensor:
    x = L.rmsnorm_apply(params["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return L.unembed_apply(params["embed"], x, policy, "unembed", hdeg)
    return L.dense_apply(params["unembed"], x, policy, "unembed", hdeg).to(torch.float32)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def lm_forward(params, cfg: ArchConfig, policy: ApproxPolicy, batch: dict,
               tp: int = 1, degree=None) -> tuple[Tensor, Tensor]:
    """Returns (logits (B, S, vocab_padded) f32, aux loss 0)."""
    tokens = batch["tokens"]
    ldeg, hdeg = split_degree(degree, cfg.n_layers, tokens.device)
    x = L.embed_apply(params["embed"], tokens, _dtype(cfg))
    B, S = tokens.shape
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    for i in range(cfg.n_layers):
        x = block_apply(layer_params(params["layers"], i), x, cfg, tp, policy,
                        "layer", positions, None if ldeg is None else ldeg[i])
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return _head(params, cfg, policy, x, hdeg), aux


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


class LMCache(NamedTuple):
    k: Tensor       # (L, B, T, KVr, D)
    v: Tensor
    length: Tensor  # (B,) int32


def init_lm_cache(cfg: ArchConfig, tp: int, batch: int, max_len: int,
                  dtype=torch.bfloat16, device="cpu") -> LMCache:
    pd = cfg.padded(tp)
    T = min(max_len, cfg.swa_window) if cfg.swa_window else max_len
    shape = (cfg.n_layers, batch, T, pd.n_kv_rep, cfg.head_dim)
    return LMCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros((batch,), dtype=torch.int32, device=device))


def lm_prefill(params, cfg: ArchConfig, policy: ApproxPolicy, cache: LMCache,
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
        cache.k[i, slot, dst] = k[0, src].to(cache.k.dtype)
        cache.v[i, slot, dst] = v[0, src].to(cache.v.dtype)
    cache.length[slot] = P
    logits = _head(params, cfg, policy, x[:, -1:], hdeg)
    return logits.to(torch.float32)[:, 0], cache


def lm_decode_step(params, cfg: ArchConfig, policy: ApproxPolicy, cache: LMCache,
                   tokens: Tensor, tp: int = 1, degree=None,
                   active=None) -> tuple[Tensor, LMCache]:
    """tokens: (B, 1).  One decode step over every slot; the new token's K/V
    is written into the cache in place.  Returns (logits (B, 1, V) f32, the
    cache with ``length + 1``).  ``active`` (B,) bool: free-slot mask for
    the attention kernel."""
    ldeg, hdeg = split_degree(degree, cfg.n_layers, tokens.device)
    pd = cfg.padded(tp)
    B = tokens.shape[0]
    x = L.embed_apply(params["embed"], tokens, _dtype(cfg))
    positions = cache.length[:, None]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        dg = None if ldeg is None else ldeg[i]
        hn = L.rmsnorm_apply(lp["ln1"], x, cfg.norm_eps)
        q, k, v = _qkv(lp, hn, cfg, pd, policy, "layer", positions, dg)
        lc = attn.KVCache(cache.k[i], cache.v[i], cache.length)
        o, _ = kdispatch.decode_attention(q, k, v, lc, window=cfg.swa_window,
                                          degree=dg, active=active)
        o = o.reshape(B, 1, pd.n_heads * cfg.head_dim)
        x = L.dense_apply(lp["wo"], o, policy, "layer/wo", dg, residual=x)
        hn = L.rmsnorm_apply(lp["ln2"], x, cfg.norm_eps)
        x = L.gated_mlp_apply(lp["mlp"], hn, policy, "layer/mlp", cfg.act,
                              dg, residual=x)
    logits = _head(params, cfg, policy, x, hdeg)
    return logits, LMCache(cache.k, cache.v, cache.length + 1)
