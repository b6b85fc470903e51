"""Fused single-token decode attention against the serving KV cache.

Wrappers around the CUDA kernels in ``csrc/flash_decode.cu`` (port of
``repro.kernels.flash_decode``): :func:`flash_decode` for the bf16/f32
cache and :func:`flash_decode_quant` for the int8 cache.  One block per
(slot, kv head) walks the slot's cache up to its valid length, which the
kernel reads from device memory; the GQA group shares each loaded K/V
tile; free slots (``active == 0``) produce exact zeros.  The int8 kernel
degrades the K/V codes to the runtime ``ebits`` (read from a device int32,
as the GEMMs do) before it dequantizes them with their per-(token, head)
scales.

:func:`decode_attn_flash` writes the new token's K/V (its int8 codes and
scales for the int8 cache) into the cache *before* the launch, in place
(``models.attention.write_token``), instead of returning a fresh cache as
the JAX reference does: the cache is the largest serving tensor and is
never copied.  ``nvalid = min(pos + 1, T)`` already counts the new token.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quantization import degrade
from repro_torch.kernels import _build

Tensor = torch.Tensor

NEG_INF = -1e30

_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_decode_plain(qg: Tensor, k: Tensor, v: Tensor, nvalid: Tensor,
                       active: Tensor) -> Tensor:
    """Plain version of :func:`flash_decode`: qg (B, KVr, G, D); k/v
    (B, T, KVr, D); nvalid/active (B,) -> (B, KVr, G, D) f32."""
    if qg.is_cuda:
        _build.plain_cuda_calls["flash_decode"] += 1
    return _decode_plain(qg, k, v, nvalid, active)


def _decode_plain(qg: Tensor, k: Tensor, v: Tensor, nvalid: Tensor,
                  active: Tensor) -> Tensor:
    B, KVr, G, D = qg.shape
    T = k.shape[1]
    q = qg.to(torch.float32) * (1.0 / math.sqrt(D))
    s = torch.einsum("bhgd,bthd->bhgt", q, k.to(torch.float32))
    valid = torch.arange(T, device=qg.device)[None, :] < nvalid.to(torch.int64)[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m), 0.0)
    vz = torch.where(valid[:, :, None, None], v.to(torch.float32), 0.0)
    out = torch.einsum("bhgt,bthd->bhgd", p, vz)
    out = out / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.where((active != 0)[:, None, None, None], out, 0.0)


def flash_decode(qg: Tensor, k: Tensor, v: Tensor, nvalid: Tensor,
                 active: Tensor) -> Tensor:
    """qg: (B, KVr, G, D) grouped queries; k/v: (B, T, KVr, D) cache (new
    token already written); nvalid/active: (B,) int32 device tensors.
    Returns (B, KVr, G, D) f32.  CPU tensors take the plain version."""
    if qg.device.type == "cpu":
        return flash_decode_plain(qg, k, v, nvalid, active)
    _build.require_sm90(qg)
    B, KVr, G, D = qg.shape
    T = k.shape[1]
    dev = qg.device
    if k.dtype not in _KV_DTYPES:
        raise ValueError(f"flash_decode takes an f32 or bf16 cache, got {k.dtype}")
    q = qg.to(torch.float32).contiguous()
    _build.expect(k, "k", k.dtype, dev, (B, T, KVr, D))
    _build.expect(v, "v", k.dtype, dev, (B, T, KVr, D))
    _build.expect(nvalid, "nvalid", torch.int32, dev, (B,))
    _build.expect(active, "active", torch.int32, dev, (B,))
    out = torch.empty((B, KVr, G, D), dtype=torch.float32, device=dev)
    rc = _build.entry("flash_decode_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), nvalid.data_ptr(),
        active.data_ptr(), out.data_ptr(), B, T, KVr, G, D, _KV_DTYPES[k.dtype],
        1.0 / math.sqrt(D), _build.stream_of(qg))
    _build.check(rc, "flash_decode")
    _build.launches["flash_decode"] += 1
    return out


def flash_decode_quant_plain(qg: Tensor, k: Tensor, ks: Tensor, v: Tensor,
                             vs: Tensor, nvalid: Tensor, active: Tensor,
                             ebits=8) -> Tensor:
    """Plain version of :func:`flash_decode_quant`, step for step as the
    reference kernel: degrade the int8 K/V codes to ``ebits``, dequantize
    with their scales, mask positions at or past ``nvalid``, softmax with
    masked entries contributing exact zeros, zero the free slots."""
    if qg.is_cuda:
        _build.plain_cuda_calls["flash_decode_quant"] += 1
    kf = degrade(k, ebits).to(torch.float32) * ks[..., None]
    vf = degrade(v, ebits).to(torch.float32) * vs[..., None]
    return _decode_plain(qg, kf, vf, nvalid, active)


def flash_decode_quant(qg: Tensor, k: Tensor, ks: Tensor, v: Tensor, vs: Tensor,
                       nvalid: Tensor, active: Tensor, ebits=8) -> Tensor:
    """int8-cache variant of :func:`flash_decode`: k/v (B, T, KVr, D) int8
    codes, ks/vs (B, T, KVr) f32 scales, ``ebits`` the runtime degree (a
    device int32 element, read by address; 8 = exact dequantization).
    Returns (B, KVr, G, D) f32.  CPU tensors take the plain version."""
    if qg.device.type == "cpu":
        return flash_decode_quant_plain(qg, k, ks, v, vs, nvalid, active, ebits)
    _build.require_sm90(qg)
    B, KVr, G, D = qg.shape
    T = k.shape[1]
    dev = qg.device
    q = qg.to(torch.float32).contiguous()
    _build.expect(k, "k", torch.int8, dev, (B, T, KVr, D), align=16)
    _build.expect(v, "v", torch.int8, dev, (B, T, KVr, D), align=16)
    _build.expect(ks, "ks", torch.float32, dev, (B, T, KVr))
    _build.expect(vs, "vs", torch.float32, dev, (B, T, KVr))
    _build.expect(nvalid, "nvalid", torch.int32, dev, (B,))
    _build.expect(active, "active", torch.int32, dev, (B,))
    if D % 4:
        raise ValueError(f"flash_decode_quant reads int8 rows as 4-byte words: "
                         f"head_dim {D} must be a multiple of 4")
    e = _build.degree_ptr(ebits, dev)
    out = torch.empty((B, KVr, G, D), dtype=torch.float32, device=dev)
    rc = _build.entry("flash_decode_quant_launch")(
        q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
        nvalid.data_ptr(), active.data_ptr(), e.data_ptr(), out.data_ptr(),
        B, T, KVr, G, D, 1.0 / math.sqrt(D), _build.stream_of(qg))
    _build.check(rc, "flash_decode_quant")
    _build.launches["flash_decode_quant"] += 1
    return out


def decode_attn_flash(q1: Tensor, knew: Tensor, vnew: Tensor, cache, *,
                      window: Optional[int] = None, active=None, degree=None,
                      plain: bool = False):
    """Drop-in for ``models.attention.decode_attn`` / ``decode_attn_quant``
    through the fused kernels (or, with ``plain=True``, their plain
    versions).

    q1: (B, 1, H, D); knew/vnew: (B, 1, KVr, D); cache: KVCache or
    QuantKVCache, updated in place.  ``active`` (B,) bool masks freed slots
    to zero output; ``degree`` is the runtime ebits of the int8 cache's
    dequantization (None = 8, exact).  Returns (out (B, 1, H, D) in
    q1.dtype, cache with ``length + 1``)."""
    from repro_torch.models.attention import (QuantKVCache, _group_q,  # kernels<->models layering
                                              write_token)

    B, _, H, D = q1.shape
    T = cache.k.shape[1]
    kvh = cache.k.shape[2]
    pos = cache.length
    write_token(cache, knew, vnew, window)
    qg = _group_q(q1, kvh)[:, 0]                       # (B, KVr, G, D)
    nvalid = torch.clamp(pos + 1, max=T).to(torch.int32)
    act = (torch.ones((B,), dtype=torch.int32, device=q1.device) if active is None
           else active.to(torch.int32))
    if isinstance(cache, QuantKVCache):
        f = flash_decode_quant_plain if plain else flash_decode_quant
        out = f(qg, cache.k, cache.ks, cache.v, cache.vs, nvalid, act,
                8 if degree is None else degree)
    else:
        f = flash_decode_plain if plain else flash_decode
        out = f(qg, cache.k, cache.v, nvalid, act)
    return out.reshape(B, 1, H, D).to(q1.dtype), cache._replace(length=pos + 1)
