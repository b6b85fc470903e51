"""Fused single-token decode attention against the serving KV cache.

Wrappers around the CUDA kernels in ``csrc/flash_decode.cu``, which replace
the TPU kernels ``repro.kernels.flash_decode._decode_kernel`` (bf16/f32
cache: :func:`flash_decode`) and ``_decode_kernel_quant`` (int8 cache:
:func:`flash_decode_quant`).  The int8 kernel degrades the K/V codes to the
runtime ``ebits`` (read from a device int32, as the GEMMs do) before it
dequantizes them with their per-(token, head) scales; free slots
(``active == 0``) produce exact zeros.

The work is bound by device-memory bytes: each cached K/V row is read once
and meets the G query rows of its group (G flops a byte of a bf16 cache,
against the card's ~20 f32 flops a byte of memory rate, so the FMAs are
register-blocked to keep up).  The kernel splits each slot's cache into
fixed-width splits at absolute positions (``split_width``, per head dim),
one block each, so the card fills; blocks past a slot's valid length
(read on the device) exit at once.  Each live split streams its rows
through a ring of 16-byte ``cp.async`` tiles and writes an f32 partial
(acc, m, l) to scratch the wrapper allocates; a second kernel from the
same C entry point merges each slot's partials in a fixed order.  A slot's
output is therefore bit-identical across launches, batch sizes and cache
capacities, no length, flag or degree is read on the host, and a call can
be captured in a CUDA graph.  The arithmetic stays f32 on the CUDA cores:
tensor cores would round q and P (bf16) or q and K (TF32) past the 1e-4 /
1e-5 gates.

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
from repro_torch.kernels import _build, meta_ops

Tensor = torch.Tensor

NEG_INF = -1e30

_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: the head dims the kernels are instantiated for: the bf16/f32 cache's and
#: the int8 cache's (no serving path reaches the int8 cache at D = 256)
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
QUANT_HEAD_DIMS = (16, 32, 64, 80, 128)

#: the kernels' copy width in bytes (``cp.async.cg``): cache pointers align to it
KV_ALIGN = 16


def split_width(D: int) -> int:
    """Cache rows a split of the decode kernels at head dim ``D`` (a
    compile-time constant of the CUDA source, asked of each loaded library
    once per head dim, not on every call; builds the library)."""
    entry = _build.entry("flash_decode_split_width")
    key = (id(entry), D)          # ctypes entry points do not hash
    if key not in _widths:
        _widths[key] = (entry, entry(D))   # held, so its id is not reused
    return _widths[key][1]


#: (id of a loaded entry point, D) -> (that entry point, its split width)
_widths: dict = {}


def _split_scratch(B: int, KVr: int, G: int, D: int, T: int, dev: torch.device,
                   dims=HEAD_DIMS) -> Tensor:
    """The partials of one launch: f32 scratch (B, KVr, ceil(T / W), G,
    D + 4) for each split's (acc, m, l; two pad floats keep its rows 16-byte
    aligned).  Raises for a head dim outside ``dims``, the ones the kernel
    was built for."""
    if D not in dims:
        raise ValueError(f"the decode kernel's head_dim must be one of {dims}, got {D}")
    n_split = -(-T // split_width(D))
    return torch.empty((B, KVr, n_split, G, D + 4), dtype=torch.float32, device=dev)


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
    _build.expect(k, "k", k.dtype, dev, (B, T, KVr, D), align=KV_ALIGN)
    _build.expect(v, "v", k.dtype, dev, (B, T, KVr, D), align=KV_ALIGN)
    _build.expect(nvalid, "nvalid", torch.int32, dev, (B,))
    _build.expect(active, "active", torch.int32, dev, (B,))
    part = _split_scratch(B, KVr, G, D, T, dev)
    out = torch.empty((B, KVr, G, D), dtype=torch.float32, device=dev)
    rc = _build.entry("flash_decode_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), nvalid.data_ptr(),
        active.data_ptr(), out.data_ptr(), part.data_ptr(), B, T, KVr, G, D,
        _KV_DTYPES[k.dtype], 1.0 / math.sqrt(D), _build.stream_of(qg))
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
    _build.expect(k, "k", torch.int8, dev, (B, T, KVr, D), align=KV_ALIGN)
    _build.expect(v, "v", torch.int8, dev, (B, T, KVr, D), align=KV_ALIGN)
    _build.expect(ks, "ks", torch.float32, dev, (B, T, KVr))
    _build.expect(vs, "vs", torch.float32, dev, (B, T, KVr))
    _build.expect(nvalid, "nvalid", torch.int32, dev, (B,))
    _build.expect(active, "active", torch.int32, dev, (B,))
    e = _build.degree_ptr(ebits, dev)
    part = _split_scratch(B, KVr, G, D, T, dev, QUANT_HEAD_DIMS)
    out = torch.empty((B, KVr, G, D), dtype=torch.float32, device=dev)
    rc = _build.entry("flash_decode_quant_launch")(
        q.data_ptr(), k.data_ptr(), ks.data_ptr(), v.data_ptr(), vs.data_ptr(),
        nvalid.data_ptr(), active.data_ptr(), e.data_ptr(), out.data_ptr(),
        part.data_ptr(), B, T, KVr, G, D, 1.0 / math.sqrt(D), _build.stream_of(qg))
    _build.check(rc, "flash_decode_quant")
    _build.launches["flash_decode_quant"] += 1
    return out


def decode_attn_flash(q1: Tensor, knew: Tensor, vnew: Tensor, cache, *,
                      window: Optional[int] = None, active=None, degree=None,
                      plain: bool = False):
    """Drop-in for ``models.attention.decode_attn`` / ``decode_attn_quant``
    through the fused kernels (or, with ``plain=True``, their plain
    versions; on meta tensors, after the cache write, the kernel's op of
    ``kernels/meta_ops.py``).

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
    if q1.is_meta:
        out = meta_ops.flash_decode(qg, cache.k)
    elif isinstance(cache, QuantKVCache):
        f = flash_decode_quant_plain if plain else flash_decode_quant
        out = f(qg, cache.k, cache.ks, cache.v, cache.vs, nvalid, act,
                8 if degree is None else degree)
    else:
        f = flash_decode_plain if plain else flash_decode
        out = f(qg, cache.k, cache.v, nvalid, act)
    return out.reshape(B, 1, H, D).to(q1.dtype), cache._replace(length=pos + 1)
