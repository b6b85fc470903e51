"""Fused single-token decode attention against the serving KV cache.

Wrappers around the CUDA kernel in ``csrc/flash_decode.cu`` (port of
``repro.kernels.flash_decode``, bf16/f32 cache; the int8-cache variant is
not ported yet).  One block per (slot, kv head) walks the slot's cache up
to its valid length, which the kernel reads from device memory; the GQA
group shares each loaded K/V tile; free slots (``active == 0``) produce
exact zeros.

:func:`decode_attn_flash` writes the new token's K/V into the cache
*before* the launch, in place (``index_put_`` at ``min(pos, T - 1)``, or
``pos % T`` for a ring), instead of returning a fresh cache as the JAX
reference does: the cache is the largest serving tensor and is never
copied.  ``nvalid = min(pos + 1, T)`` already counts the new token.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

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


def decode_attn_flash(q1: Tensor, knew: Tensor, vnew: Tensor, cache, *,
                      window: Optional[int] = None, active=None,
                      plain: bool = False):
    """Drop-in for ``models.attention.decode_attn`` through the fused
    kernel (or, with ``plain=True``, its plain version).

    q1: (B, 1, H, D); knew/vnew: (B, 1, KVr, D); cache: KVCache, updated in
    place.  ``active`` (B,) bool masks freed slots to zero output.  Returns
    (out (B, 1, H, D) in q1.dtype, cache with ``length + 1``)."""
    from repro_torch.models.attention import KVCache, _group_q  # kernels<->models layering

    B, _, H, D = q1.shape
    T = cache.k.shape[1]
    kvh = cache.k.shape[2]
    pos = cache.length
    ring = window is not None and window <= T
    slot = torch.remainder(pos, T) if ring else torch.clamp(pos, max=T - 1)
    bidx = torch.arange(B, device=q1.device)
    cache.k[bidx, slot] = knew[:, 0].to(cache.k.dtype)
    cache.v[bidx, slot] = vnew[:, 0].to(cache.v.dtype)
    qg = _group_q(q1, kvh)[:, 0]                       # (B, KVr, G, D)
    nvalid = torch.clamp(pos + 1, max=T).to(torch.int32)
    act = (torch.ones((B,), dtype=torch.int32, device=q1.device) if active is None
           else active.to(torch.int32))
    f = flash_decode_plain if plain else flash_decode
    out = f(qg, cache.k, cache.v, nvalid, act)
    return out.reshape(B, 1, H, D).to(q1.dtype), KVCache(cache.k, cache.v, pos + 1)
