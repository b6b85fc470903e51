"""GQA attention: full and blockwise online-softmax prefill paths, the KV
cache and single-token decode, in PyTorch.

These are the plain paths (the counterparts of the reference's jnp paths).
Model call sites route through ``kernels/dispatch.py``, which launches the
CUDA kernels for CUDA tensors.

Layout conventions:
  q        (B, S, H, D)
  k, v     (B, S, KVr, D)
  cache    (B, T_max, KVr, D) per layer

GQA is computed grouped — q reshaped to (B, S, KVr, G, D) — so repeated KV
is never materialized.  Unlike the functional reference, the decode paths
write the new token into the cache in place (the cache is never copied).

Two cache types: :class:`KVCache` (bf16/f32) and :class:`QuantKVCache`
(int8 codes with per-(token, head) f32 scales, ``REPRO_KV_INT8=1``: half
the bytes of a bf16 cache to hold and to read on every decode step).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor

NEG_INF = -1e30


def repeat_kv(k: Tensor, target_heads: int) -> Tensor:
    """(B, S, KV, D) -> (B, S, target, D) by head repetition."""
    kv = k.shape[2]
    if kv == target_heads:
        return k
    if target_heads % kv:
        raise ValueError(f"{target_heads} heads do not repeat {kv} kv heads")
    return torch.repeat_interleave(k, target_heads // kv, dim=2)


def _group_q(q: Tensor, kv_heads: int) -> Tensor:
    """(B, S, H, D) -> (B, S, KVr, G, D)."""
    B, S, H, D = q.shape
    if H % kv_heads:
        raise ValueError(f"{H} query heads do not group over {kv_heads}")
    return q.reshape(B, S, kv_heads, H // kv_heads, D)


def _mask(S: int, causal: bool, window: Optional[int], device) -> Tensor:
    ii = torch.arange(S, device=device)[:, None]
    jj = torch.arange(S, device=device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=device)
    if causal:
        mask &= jj <= ii
    if window is not None:
        mask &= jj > ii - window
    return mask


def attn_full(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
              window: Optional[int] = None) -> Tensor:
    B, S, H, D = q.shape
    kvh = k.shape[2]
    qg = _group_q(q, kvh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(torch.float32),
                          k.to(torch.float32)) / math.sqrt(D)
    scores = torch.where(_mask(S, causal, window, q.device), scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(torch.float32),
                       v.to(torch.float32)).to(v.dtype)
    return out.reshape(B, S, H, D)


def attn_blockwise(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                   window: Optional[int] = None, q_block: int = 512,
                   kv_block: int = 512) -> Tensor:
    """Memory-bounded attention: online softmax over kv blocks per q block
    (short sequences take :func:`attn_full`)."""
    B, S, H, D = q.shape
    if S <= max(q_block, 256):
        return attn_full(q, k, v, causal=causal, window=window)
    q_block = min(q_block, S)
    while S % q_block:
        q_block //= 2
    kv_block = min(kv_block, S)
    while S % kv_block:
        kv_block //= 2
    kvh = k.shape[2]
    qg = _group_q(q, kvh).to(torch.float32) / math.sqrt(D)   # (B,S,KV,G,D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    full = _mask(S, causal, window, q.device)
    out = torch.empty((B, S, kvh, qg.shape[3], D), dtype=torch.float32,
                      device=q.device)
    for q0 in range(0, S, q_block):
        qb = qg[:, q0:q0 + q_block]
        acc = torch.zeros_like(qb)
        mx = torch.full((*qb.shape[:-1], 1), NEG_INF, device=q.device)
        den = torch.zeros_like(mx)
        for k0 in range(0, S, kv_block):
            m = full[q0:q0 + q_block, k0:k0 + kv_block]
            if not bool(m.any()):
                continue
            s = torch.einsum("bqkgd,btkd->bqkgt", qb, kf[:, k0:k0 + kv_block])
            s = torch.where(m[None, :, None, None, :], s, NEG_INF)
            new_mx = torch.maximum(mx, s.amax(dim=-1, keepdim=True))
            corr = torch.exp(mx - new_mx)
            p = torch.exp(s - new_mx)
            den = den * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.einsum("bqkgt,btkd->bqkgd", p,
                                            vf[:, k0:k0 + kv_block])
            mx = new_mx
        out[:, q0:q0 + q_block] = acc / torch.clamp(den, min=1e-30)
    return out.reshape(B, S, H, D).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode (one new token against the cache)
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: Tensor          # (B, T, KVr, D)
    v: Tensor          # (B, T, KVr, D)
    length: Tensor     # (B,) int32 — tokens currently in cache


class QuantKVCache(NamedTuple):
    """int8 KV cache with per-(token, head) scales."""

    k: Tensor          # (B, T, KVr, D) int8
    v: Tensor
    ks: Tensor         # (B, T, KVr) f32
    vs: Tensor
    length: Tensor     # (B,) int32


def _q8(x: Tensor):
    """Per-(token, head) symmetric int8 quantization over the last axis:
    scale ``max(amax, 1e-30) / 127``, round half to even, clip to ±127.
    Returns (int8 codes, f32 scales without the last axis); bit-identical
    to the reference's ``_q8``."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-30) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def init_quant_kv_cache(batch: int, max_len: int, kv_heads: int, head_dim: int,
                        device="cpu") -> QuantKVCache:
    shape = (batch, max_len, kv_heads, head_dim)
    return QuantKVCache(
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape, dtype=torch.int8, device=device),
        torch.zeros(shape[:3], dtype=torch.float32, device=device),
        torch.zeros(shape[:3], dtype=torch.float32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def token_rows(T: int, length: Tensor, window: Optional[int] = None) -> Tensor:
    """The cache row each slot's next token is written to: ``length % T``
    for a ring (``window <= T``), ``min(length, T - 1)`` otherwise."""
    if window is not None and window <= T:
        return torch.remainder(length, T)
    return torch.clamp(length, max=T - 1)


def write_token(cache, knew: Tensor, vnew: Tensor,
                window: Optional[int] = None) -> None:
    """Write each slot's new token K/V (B, 1, KVr, D) into its cache row
    (:func:`token_rows`), in place.  The int8 cache stores the token's codes
    and scales (:func:`_q8`)."""
    pos = cache.length
    slot = token_rows(cache.k.shape[1], pos, window)
    bidx = torch.arange(pos.shape[0], device=pos.device)
    if isinstance(cache, QuantKVCache):
        kq, ks = _q8(knew[:, 0])
        vq, vs = _q8(vnew[:, 0])
        cache.k[bidx, slot] = kq
        cache.v[bidx, slot] = vq
        cache.ks[bidx, slot] = ks
        cache.vs[bidx, slot] = vs
    else:
        cache.k[bidx, slot] = knew[:, 0].to(cache.k.dtype)
        cache.v[bidx, slot] = vnew[:, 0].to(cache.v.dtype)


def _attend_cache(q1: Tensor, kf: Tensor, vf: Tensor, length: Tensor) -> Tensor:
    """Softmax attention of q1 (B, 1, H, D) over the valid prefix of f32
    keys/values (B, T, KVr, D) -> (B, 1, H, D) in q1.dtype."""
    B, _, H, D = q1.shape
    T, kvh = kf.shape[1], kf.shape[2]
    qg = _group_q(q1, kvh)[:, 0]
    s = torch.einsum("bkgd,btkd->bkgt", qg.to(torch.float32), kf) / math.sqrt(D)
    n_valid = torch.clamp(length + 1, max=T)
    valid = torch.arange(T, device=q1.device)[None, :] < n_valid[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgt,btkd->bkgd", p, vf)
    return out.reshape(B, 1, H, D).to(q1.dtype)


def decode_attn(q1: Tensor, knew: Tensor, vnew: Tensor, cache: KVCache, *,
                window: Optional[int] = None) -> tuple[Tensor, KVCache]:
    """q1: (B, 1, H, D); knew/vnew: (B, 1, KVr, D).  Writes the new token
    into the cache in place (:func:`write_token`) and attends over the valid
    prefix.  Returns (out (B, 1, H, D), cache with ``length + 1``)."""
    write_token(cache, knew, vnew, window)
    out = _attend_cache(q1, cache.k.to(torch.float32), cache.v.to(torch.float32),
                        cache.length)
    return out, KVCache(cache.k, cache.v, cache.length + 1)


def decode_attn_quant(q1: Tensor, knew: Tensor, vnew: Tensor,
                      cache: QuantKVCache, *, window: Optional[int] = None
                      ) -> tuple[Tensor, QuantKVCache]:
    """Decode against the int8 cache: quantize the new K/V into it in place,
    dequantize exactly at attention time (no runtime degree, free slots not
    zeroed — the reference's jnp path; the kernel route is
    ``kernels/flash_decode.py``).  Returns (out, cache with ``length + 1``)."""
    write_token(cache, knew, vnew, window)
    kf = cache.k.to(torch.float32) * cache.ks[..., None]
    vf = cache.v.to(torch.float32) * cache.vs[..., None]
    out = _attend_cache(q1, kf, vf, cache.length)
    return out, cache._replace(length=cache.length + 1)
