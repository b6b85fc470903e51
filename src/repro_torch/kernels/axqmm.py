"""axqmm — block-quantized, effective-bits, runtime-degradable GEMM.

Wrappers around the CUDA kernels in ``csrc/axqmm.cu`` (port of
``repro.kernels.axqmm``).  The weight arrives prepacked
(:class:`~repro_torch.kernels.qstore.PackedQWeight`: ``(N, K)`` int8
K-major + ``(N, K // bk)`` f32 scales), so the per-call work outside the
kernel is the activation quantization; the kernel degrades both int8
operands to the runtime ``ebits`` (read from a device int32), takes exact
int32 block dots on the int8 tensor cores and folds them scaled in f32 in
block order, with the bias/residual epilogue (:func:`axqmm_packed`) or the
gate (:func:`axqmm_gated_packed`) fused before its single write.

:func:`plan` picks the kernel's tile configuration and how far K is split
across blocks (decode shapes, M <= 16, split until the card holds several
blocks an SM); a split launch gets an int32 scratch of per-unit sums from
:func:`_scratch`, which the C entry point's second kernel folds in block
order, so the result does not depend on the split; a long prefill gets
a scratch its pre-pass degrades x and the weights into once.

The expert-batched entries (:func:`axqmm_experts_packed`,
:func:`axqmm_gated_experts_packed`) take E experts' products of one shape
— x ``(E, C, K)`` against a pack with a leading E — in one launch of the
same kernels, the expert on the grid's last axis: the counterpart of the
reference's ``vmap`` of the Pallas call over an MoE layer's experts
(``models/moe.py``).  Their plan counts the tiles of every expert, and each
expert's output is bit-identical to a 2-D launch on its slice.

Each wrapper launches its kernel for a CUDA tensor (or raises) and uses
the plain PyTorch version only for a CPU tensor.  The plain versions
(``*_plain``) are the ``qmm_*_packed_ref`` oracles of
``core/quantization.py`` with the same epilogue.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.quantization import (qmm_gated_packed_ref,
                                           qmm_packed_ref, quantize_block)
from repro_torch.kernels import _build, meta_ops
from repro_torch.kernels.qstore import PackedQWeight, prepack_weight, resolve_block

Tensor = torch.Tensor


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default form


#: gated-MLP activations (the reference's jax.nn forms)
ACTS = {"silu": F.silu, "gelu": _gelu, "relu": F.relu}
_ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2}

#: the kernels' least step of K in bytes: the packed block must be a multiple of it
KERNEL_KC = 64

#: the C entry points' tile configurations (``cfg``): decode (M <= 16, one
#: warp a block on 16 weight rows), 64-row tiles (mma.sync, K may be split)
#: and 128-row tiles (wgmma; a block that is a multiple of 128 bytes, K not
#: split)
DECODE, TILE_SMALL, TILE_LARGE = range(3)
#: the largest M the decode kernel takes (its slots fill the MMA's n side)
DECODE_M = 16
#: output rows, columns of a tile (gated: columns of each of up and gate)
_TILE = {TILE_SMALL: (64, 64, 32), TILE_LARGE: (128, 128, 64)}
#: decode blocks (one warp each) wanted an SM when K is split, and the
#: blocks an SM past which K is not split (the combine costs more than the
#: SMs it fills: tools/tune_axqmm.py --sweep)
DECODE_BLOCKS_PER_SM = 8
DECODE_NO_SPLIT_PER_SM = 2
#: the most parts a decode split cuts a quantization block into (the
#: combine kernel's unrolled bound)
MAX_PARTS = 4
#: the most scratch a split launch may ask for
SCRATCH_MAX_BYTES = 64 << 20
#: from this many rows a 128-row-tile launch degrades x and the weights
#: once, in a pre-pass, instead of in every tile that meets them
PREDEGRADE_M = 1024


class Plan(NamedTuple):
    """A launch's tile configuration, splits of K and units a quantization
    block (``part`` > 1 splits inside a block, at decode only)."""

    cfg: int
    n_split: int = 1
    part: int = 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def plan(M: int, N: int, K: int, bk: int, gated: bool, sms: int,
         experts: int = 1) -> Plan:
    """The launch of an (M, K) x (K, N) call with quantization block ``bk``
    on a card of ``sms`` SMs (of ``experts`` such calls in one launch: the
    tiles counted below are every expert's).  Decode (M <= 16) splits K at block edges
    toward ``DECODE_BLOCKS_PER_SM`` one-warp blocks an SM when its 16-row
    tiles are fewer than ``DECODE_NO_SPLIT_PER_SM`` an SM, and at exact parts
    of a block where whole blocks cannot give one block an SM; prefill takes
    128-row tiles when they fill the card, else 64-row ones, split at block
    edges when those fill less than half of it."""
    nb = K // bk
    if M <= DECODE_M:
        cfg, tiles = DECODE, _cdiv(N, 16) * experts
        want = _cdiv(DECODE_BLOCKS_PER_SM * sms, tiles) \
            if tiles < DECODE_NO_SPLIT_PER_SM * sms else 1
    else:
        rows, cols, gated_cols = _TILE[TILE_LARGE]
        if (bk % 128 == 0 and _cdiv(M, rows) * _cdiv(N, gated_cols if gated else cols)
                * experts >= sms):
            return Plan(TILE_LARGE)
        cfg = TILE_SMALL
        rows, cols, gated_cols = _TILE[TILE_SMALL]
        tiles = _cdiv(M, rows) * _cdiv(N, gated_cols if gated else cols) * experts
        want = _cdiv(sms, tiles) if 2 * tiles < sms else 1
    n_split, part = min(want, nb), 1
    while (cfg == DECODE and tiles * n_split < sms and part < MAX_PARTS
           and bk % (2 * part * KERNEL_KC) == 0):
        part *= 2                     # parts of a block, until one block an SM
        n_split = min(_cdiv(sms, tiles), nb * part)
    if (n_split <= 1
            or experts * _scratch_bytes(M, N, nb * part, gated) > SCRATCH_MAX_BYTES):
        return Plan(cfg)
    return Plan(cfg, n_split, part)


def blocks(p: Plan, M: int, N: int, gated: bool, experts: int = 1) -> int:
    """Thread blocks of the main kernel of launch ``p`` over ``experts``
    experts (the combine kernel of a split launch not counted)."""
    if p.cfg == DECODE:
        return _cdiv(N, 16) * p.n_split * experts
    rows, cols, gated_cols = _TILE[p.cfg]
    return _cdiv(M, rows) * _cdiv(N, gated_cols if gated else cols) * p.n_split * experts


def _scratch_bytes(M: int, N: int, units: int, gated: bool) -> int:
    return (2 if gated else 1) * units * M * N * 4


def _scratch(p: Plan, M: int, N: int, K: int, bk: int, gated: bool, device,
             experts: int = 0):
    """The scratch of a launch: for a split launch an int32 (M, N) plane of
    sums a unit (a block, or a part of one) of each weight; for a long
    prefill on 128-row tiles the int8 codes of x and of each weight, which a
    pre-pass degrades once; otherwise None.  An expert-batched launch
    (``experts`` > 0) has one such scratch an expert, on a leading axis."""
    g = 2 if gated else 1
    lead = (experts,) if experts else ()
    if p.n_split > 1:
        return torch.empty((*lead, g, K // bk * p.part, M, N), dtype=torch.int32,
                           device=device)
    if p.cfg == TILE_LARGE and M >= PREDEGRADE_M:
        return torch.empty((*lead, (M + g * N) * K), dtype=torch.int8, device=device)
    return None


def _plan_for(qx: Tensor, N: int, bk: int, gated: bool) -> Plan:
    M, K = qx.shape
    return plan(M, N, K, bk, gated, _build.sm_count(qx))


def quantize_for_axqmm(x: Tensor, bk: int):
    """Per-(row, k-block) int8 quantization of the activation x (M, K) —
    the one quantizer shared by kernel, oracle and prepack."""
    qt = quantize_block(x.to(torch.float32), bk)
    return qt.values, qt.scales


def _count_plain(name: str, x: Tensor) -> None:
    if x.is_cuda:
        _build.plain_cuda_calls[name] += 1


def expert_pack(pw: PackedQWeight, e: int) -> PackedQWeight:
    """Expert ``e``'s slice of an expert-batched pack (views)."""
    return PackedQWeight(pw.qw[e], pw.scales[e])


def axqmm_packed_plain(x: Tensor, pw: PackedQWeight, ebits=8, *,
                       bias: Tensor | None = None,
                       residual: Tensor | None = None) -> Tensor:
    """Plain version of :func:`axqmm_packed`: the oracle plus the same
    ordered f32 epilogue adds."""
    _count_plain("axqmm", x)
    y = qmm_packed_ref(x.to(torch.float32), pw.qw, pw.scales, ebits)
    if bias is not None:
        y = y + bias.to(torch.float32)[None, :]
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y


def axqmm_gated_plain(x: Tensor, pw_up: PackedQWeight, pw_gate: PackedQWeight,
                      ebits=8, *, act: str = "silu") -> Tensor:
    """Plain version of :func:`axqmm_gated_packed`."""
    _count_plain("axqmm_gated", x)
    return qmm_gated_packed_ref(x.to(torch.float32), pw_up.qw, pw_up.scales,
                                pw_gate.qw, pw_gate.scales, ACTS[act], ebits)


def _check_packed(pw: PackedQWeight, name: str, K: int, device, lead: tuple = ()) -> None:
    """A pack the kernel takes: (*lead, N, K) int8 and its scales, with K
    and a block that is a multiple of the kernels' step."""
    N, bk = pw.n, pw.block
    if pw.k != K:
        raise ValueError(f"{name}: packed K={pw.k} but x has K={K}")
    if bk % KERNEL_KC:
        raise ValueError(f"{name}: the kernel needs a quantization block that "
                         f"is a multiple of {KERNEL_KC}, got {bk}")
    _build.expect(pw.qw, f"{name}.qw", torch.int8, device, (*lead, N, K), align=16)
    _build.expect(pw.scales, f"{name}.scales", torch.float32, device,
                  (*lead, N, K // bk))


def axqmm_packed(x: Tensor, pw: PackedQWeight, ebits=8, *,
                 bias: Tensor | None = None,
                 residual: Tensor | None = None) -> Tensor:
    """float x (M, K) @ prepacked weight -> (M, N) f32, with optional
    ``bias`` (N,) and ``residual`` (M, N) added in the kernel's f32
    epilogue.  CUDA tensors launch the kernel; CPU tensors take the plain
    version; meta tensors take the kernel's op (``kernels/meta_ops.py``:
    its output's shape, no data)."""
    if x.device.type == "cpu":
        return axqmm_packed_plain(x, pw, ebits, bias=bias, residual=residual)
    if x.device.type == "meta":
        return meta_ops.axqmm(x, pw.qw)
    qx, sx = quantize_for_axqmm(x, pw.block)
    return axqmm_quantized(qx, sx, pw, ebits, bias=bias, residual=residual)


def axqmm_quantized(qx: Tensor, sx: Tensor, pw: PackedQWeight, ebits=8, *,
                    bias: Tensor | None = None,
                    residual: Tensor | None = None) -> Tensor:
    """The kernel launch alone, on an already-quantized activation
    (qx (M, K) int8, sx (M, K // bk) f32) — CUDA tensors only."""
    _build.require_sm90(qx)
    M, K = qx.shape
    N, bk = pw.n, pw.block
    dev = qx.device
    _check_packed(pw, "weight", K, dev)
    _build.expect(qx, "qx", torch.int8, dev, (M, K), align=16)
    _build.expect(sx, "sx", torch.float32, dev, (M, K // bk))
    b = None
    if bias is not None:
        b = bias.to(torch.float32).contiguous()
        _build.expect(b, "bias", torch.float32, dev, (N,))
    r = None
    if residual is not None:
        r = residual.to(torch.float32).contiguous()
        _build.expect(r, "residual", torch.float32, dev, (M, N))
    e = _build.degree_ptr(ebits, dev)
    p = _plan_for(qx, N, bk, False)
    scratch = _scratch(p, M, N, K, bk, False, dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    rc = _build.entry("axqmm_launch")(
        qx.data_ptr(), sx.data_ptr(), pw.qw.data_ptr(), pw.scales.data_ptr(),
        None if b is None else b.data_ptr(), None if r is None else r.data_ptr(),
        e.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        M, N, K, bk, *p, _build.stream_of(qx))
    _build.check(rc, "axqmm")
    _build.launches["axqmm"] += 1
    return out


def axqmm_gated_packed(x: Tensor, pw_up: PackedQWeight, pw_gate: PackedQWeight,
                       ebits=8, *, act: str = "silu") -> Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` -> (M, N) f32 in one launch: both
    GEMMs read one staged x tile, and the up/gate sums meet in the
    epilogue.  CPU tensors take the plain version; meta tensors the kernel's
    op."""
    if act not in _ACT_CODES:
        raise ValueError(f"act must be one of {sorted(_ACT_CODES)}, got {act!r}")
    if pw_up.n != pw_gate.n or pw_up.block != pw_gate.block:
        raise ValueError("up/gate packs must agree in N and block")
    if x.device.type == "cpu":
        return axqmm_gated_plain(x, pw_up, pw_gate, ebits, act=act)
    if x.device.type == "meta":
        return meta_ops.axqmm_gated(x, pw_up.qw, pw_gate.qw)
    qx, sx = quantize_for_axqmm(x, pw_up.block)
    return axqmm_gated_quantized(qx, sx, pw_up, pw_gate, ebits, act=act)


def axqmm_gated_quantized(qx: Tensor, sx: Tensor, pw_up: PackedQWeight,
                          pw_gate: PackedQWeight, ebits=8, *,
                          act: str = "silu") -> Tensor:
    """The gated kernel launch alone, on an already-quantized activation —
    CUDA tensors only."""
    _build.require_sm90(qx)
    M, K = qx.shape
    N, bk = pw_up.n, pw_up.block
    dev = qx.device
    _check_packed(pw_up, "up", K, dev)
    _check_packed(pw_gate, "gate", K, dev)
    _build.expect(qx, "qx", torch.int8, dev, (M, K), align=16)
    _build.expect(sx, "sx", torch.float32, dev, (M, K // bk))
    e = _build.degree_ptr(ebits, dev)
    p = _plan_for(qx, N, bk, True)
    scratch = _scratch(p, M, N, K, bk, True, dev)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    rc = _build.entry("axqmm_gated_launch")(
        qx.data_ptr(), sx.data_ptr(), pw_up.qw.data_ptr(), pw_up.scales.data_ptr(),
        pw_gate.qw.data_ptr(), pw_gate.scales.data_ptr(), e.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), M, N, K, bk,
        _ACT_CODES[act], *p, _build.stream_of(qx))
    _build.check(rc, "axqmm_gated")
    _build.launches["axqmm_gated"] += 1
    return out


def axqmm(x: Tensor, w: Tensor, *, block: int = 256, ebits=8,
          bias: Tensor | None = None, residual: Tensor | None = None,
          plain: bool = False) -> Tensor:
    """float x (M, K) @ float w (K, N): packs the weight on the fly (the
    prepack quantizer) and defers to the packed entry."""
    pw = prepack_weight(w, resolve_block(x.shape[-1], block))
    f = axqmm_packed_plain if plain else axqmm_packed
    return f(x, pw, ebits, bias=bias, residual=residual)


def axqmm_gated(x: Tensor, w_up: Tensor, w_gate: Tensor, *, block: int = 256,
                ebits=8, act: str = "silu", plain: bool = False) -> Tensor:
    """On-the-fly-packed variant of :func:`axqmm_gated_packed`."""
    bk = resolve_block(x.shape[-1], block)
    f = axqmm_gated_plain if plain else axqmm_gated_packed
    return f(x, prepack_weight(w_up, bk), prepack_weight(w_gate, bk), ebits,
             act=act)


# ---------------------------------------------------------------------------
# expert-batched launches (MoE)
# ---------------------------------------------------------------------------


def axqmm_experts_plain(x: Tensor, pw: PackedQWeight, ebits=8) -> Tensor:
    """Plain version of :func:`axqmm_experts_packed`: the 2-D oracle on each
    expert's slice, in expert order."""
    _count_plain("axqmm_experts", x)
    x = x.to(torch.float32)
    return torch.stack([qmm_packed_ref(x[e], pw.qw[e], pw.scales[e], ebits)
                        for e in range(x.shape[0])])


def axqmm_gated_experts_plain(x: Tensor, pw_up: PackedQWeight, pw_gate: PackedQWeight,
                              ebits=8, *, act: str = "silu") -> Tensor:
    """Plain version of :func:`axqmm_gated_experts_packed`."""
    _count_plain("axqmm_gated_experts", x)
    x = x.to(torch.float32)
    return torch.stack([qmm_gated_packed_ref(x[e], pw_up.qw[e], pw_up.scales[e],
                                             pw_gate.qw[e], pw_gate.scales[e], ACTS[act],
                                             ebits)
                        for e in range(x.shape[0])])


def _check_experts(x: Tensor, packs, name: str) -> None:
    """An expert-batched call's shapes: x (E, C, K), each pack (E, N, K)
    with one N and block."""
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (E, C, K), got {tuple(x.shape)}")
    E = x.shape[0]
    for pw in packs:
        if pw.qw.dim() != 3 or pw.qw.shape[0] != E or pw.scales.shape[0] != E:
            raise ValueError(f"{name}: the pack must be (E={E}, N, K), got "
                             f"{tuple(pw.qw.shape)} with scales {tuple(pw.scales.shape)}")
    if any(pw.n != packs[0].n or pw.block != packs[0].block for pw in packs):
        raise ValueError(f"{name}: up/gate packs must agree in N and block")


def axqmm_experts_packed(x: Tensor, pw: PackedQWeight, ebits=8) -> Tensor:
    """float x (E, C, K) @ each expert's packed weight -> (E, C, N) f32: E
    products in one launch.  CUDA tensors launch the kernel; CPU tensors
    take the plain version; meta tensors the kernel's op."""
    _check_experts(x, (pw,), "axqmm_experts")
    if x.device.type == "cpu":
        return axqmm_experts_plain(x, pw, ebits)
    if x.device.type == "meta":
        return meta_ops.axqmm_experts(x, pw.qw)
    qx, sx = quantize_for_axqmm(x, pw.block)
    return axqmm_experts_quantized(qx, sx, pw, ebits)


def _experts_operands(qx: Tensor, sx: Tensor, packs, name: str):
    """Check an expert-batched launch's operands; returns (E, C, N, K, bk)."""
    _build.require_sm90(qx)
    _check_experts(qx, packs, name)
    E, C, K = qx.shape
    N, bk = packs[0].n, packs[0].block
    dev = qx.device
    for pw, what in zip(packs, ("up", "gate") if len(packs) == 2 else ("weight",)):
        _check_packed(pw, f"{name} {what}", K, dev, (E,))
    _build.expect(qx, "qx", torch.int8, dev, (E, C, K), align=16)
    _build.expect(sx, "sx", torch.float32, dev, (E, C, K // bk))
    return E, C, N, K, bk


def axqmm_experts_quantized(qx: Tensor, sx: Tensor, pw: PackedQWeight, ebits=8) -> Tensor:
    """The expert-batched launch alone, on an already-quantized activation
    (qx (E, C, K) int8, sx (E, C, K // bk) f32) — CUDA tensors only."""
    E, C, N, K, bk = _experts_operands(qx, sx, (pw,), "axqmm_experts")
    dev = qx.device
    e = _build.degree_ptr(ebits, dev)
    p = plan(C, N, K, bk, False, _build.sm_count(qx), E)
    scratch = _scratch(p, C, N, K, bk, False, dev, E)
    out = torch.empty((E, C, N), dtype=torch.float32, device=dev)
    rc = _build.entry("axqmm_experts_launch")(
        qx.data_ptr(), sx.data_ptr(), pw.qw.data_ptr(), pw.scales.data_ptr(), e.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), E, C, N, K, bk,
        *p, _build.stream_of(qx))
    _build.check(rc, "axqmm_experts")
    _build.launches["axqmm_experts"] += 1
    return out


def axqmm_gated_experts_packed(x: Tensor, pw_up: PackedQWeight, pw_gate: PackedQWeight,
                               ebits=8, *, act: str = "silu") -> Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` for each of E experts -> (E, C, N)
    f32 in one launch.  CPU tensors take the plain version; meta tensors
    the kernel's op."""
    if act not in _ACT_CODES:
        raise ValueError(f"act must be one of {sorted(_ACT_CODES)}, got {act!r}")
    _check_experts(x, (pw_up, pw_gate), "axqmm_gated_experts")
    if x.device.type == "cpu":
        return axqmm_gated_experts_plain(x, pw_up, pw_gate, ebits, act=act)
    if x.device.type == "meta":
        return meta_ops.axqmm_gated_experts(x, pw_up.qw, pw_gate.qw)
    qx, sx = quantize_for_axqmm(x, pw_up.block)
    return axqmm_gated_experts_quantized(qx, sx, pw_up, pw_gate, ebits, act=act)


def axqmm_gated_experts_quantized(qx: Tensor, sx: Tensor, pw_up: PackedQWeight,
                                  pw_gate: PackedQWeight, ebits=8, *,
                                  act: str = "silu") -> Tensor:
    """The expert-batched gated launch alone, on an already-quantized
    activation — CUDA tensors only."""
    E, C, N, K, bk = _experts_operands(qx, sx, (pw_up, pw_gate), "axqmm_gated_experts")
    dev = qx.device
    e = _build.degree_ptr(ebits, dev)
    p = plan(C, N, K, bk, True, _build.sm_count(qx), E)
    scratch = _scratch(p, C, N, K, bk, True, dev, E)
    out = torch.empty((E, C, N), dtype=torch.float32, device=dev)
    rc = _build.entry("axqmm_gated_experts_launch")(
        qx.data_ptr(), sx.data_ptr(), pw_up.qw.data_ptr(), pw_up.scales.data_ptr(),
        pw_gate.qw.data_ptr(), pw_gate.scales.data_ptr(), e.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), E, C, N, K, bk, _ACT_CODES[act],
        *p, _build.stream_of(qx))
    _build.check(rc, "axqmm_gated_experts")
    _build.launches["axqmm_gated_experts"] += 1
    return out
