"""Effective-bits block quantization (DESIGN.md §2.1), in PyTorch.

Symmetric int8 quantization per (row, k-block) plus the runtime DyFXU
degrade: round-and-shift each int8 mantissa to ``ebits`` effective bits.
These functions are bit-identical to ``repro.core.quantization`` on the CPU:
``torch.round`` rounds half to even like ``jnp.round``, and ``x / scale``
stays a division (a multiply by the reciprocal would round differently).

The ``qmm_*`` functions are the plain oracles of the AXQ GEMM kernels
(``kernels/axqmm.py``).  Their per-block integer dots are taken in float64,
which is exact for any block (products are at most 127², so a block sum stays
far below 2**53) and runs on the CPU and the card alike; the per-block
scaled terms are then summed in block order, the order the kernel
accumulates them in.  One block's (M, N) product is alive at a time (the
reference's einsum builds all (M, N, nb) at once; each entry is the same
exact integer either way).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class QTensor(NamedTuple):
    """Block-quantized tensor: int8 values (..., K) + per-block f32 scales
    (..., K // block)."""

    values: Tensor
    scales: Tensor
    block: int

    @property
    def shape(self):
        return self.values.shape


def quantize_block(x: Tensor, block: int = 256, axis: int = -1) -> QTensor:
    """Symmetric int8 block quantization along ``axis`` (the contraction
    dim).  ``x`` should be float32 for bit-identity with the reference."""
    if axis != -1:
        x = x.movedim(axis, -1)
    *lead, K = x.shape
    if K % block:
        raise ValueError(f"contraction dim {K} not divisible by block {block}")
    xb = x.reshape(*lead, K // block, block)
    amax = xb.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return QTensor(q.reshape(*lead, K), scale[..., 0].to(torch.float32), block)


def _shift_of(ebits, device) -> Tensor:
    """``max(8 - ebits, 0)`` as an int32 tensor on ``device``; ``ebits`` may
    be a Python int or an int32 tensor (read on the device, no host sync)."""
    e = torch.as_tensor(ebits, dtype=torch.int32, device=device)
    return torch.clamp(8 - e, min=0)


def degrade(q: Tensor, ebits) -> Tensor:
    """Drop int8 ``q`` to ``ebits`` effective bits by round-to-nearest at
    2^(8-e), saturating at ±127 — the runtime DyFXU knob."""
    shift = _shift_of(ebits, q.device)
    q32 = q.to(torch.int32)
    one = torch.ones((), dtype=torch.int32, device=q.device)
    half = torch.where(shift > 0,
                       torch.bitwise_left_shift(one, torch.clamp(shift - 1, min=0)),
                       torch.zeros_like(one))
    down = torch.bitwise_right_shift(q32 + half, shift)
    out = torch.clamp(torch.bitwise_left_shift(down, shift), -127, 127)
    return torch.where(shift > 0, out, q32).to(torch.int8)


def dequantize(qt: QTensor) -> Tensor:
    *lead, K = qt.values.shape
    v = qt.values.reshape(*lead, K // qt.block, qt.block).to(torch.float32)
    return (v * qt.scales[..., None]).reshape(*lead, K)


def qmm_packed_ref(x: Tensor, qw: Tensor, sw: Tensor, ebits=8,
                   out_dtype=torch.float32) -> Tensor:
    """Block-quantized matmul against a prepacked K-major weight.

    x: (M, K) float; qw: (N, K) int8; sw: (N, K // block) f32.  The
    activation is quantized here; both operands are degraded to ``ebits``
    and combined as per-block integer dots scaled by the block scales."""
    M, K = x.shape
    N, K2 = qw.shape
    if K != K2:
        raise ValueError(f"contraction mismatch: x has K={K}, weight {K2}")
    nb = sw.shape[-1]
    block = K // nb
    qx = quantize_block(x.to(torch.float32), block)
    vx = degrade(qx.values, ebits).reshape(M, nb, block)
    vw = degrade(qw, ebits).reshape(N, nb, block)
    y = None
    for b in range(nb):
        acc = (vx[:, b].to(torch.float64) @ vw[:, b].to(torch.float64).t()).to(torch.float32)
        term = acc * (qx.scales[:, None, b] * sw[None, :, b])
        y = term if y is None else y + term
    return y.to(out_dtype)


def qmm_ref(x: Tensor, w: Tensor, block: int = 256, ebits=8,
            out_dtype=torch.float32) -> Tensor:
    """x (M, K) @ float w (K, N) with the weight quantized on the fly (the
    same ``quantize_block`` the prepack pass runs once)."""
    if x.shape[-1] != w.shape[0]:
        raise ValueError(f"contraction mismatch: {x.shape} @ {w.shape}")
    qw = quantize_block(w.t().to(torch.float32), block)
    return qmm_packed_ref(x, qw.values, qw.scales, ebits, out_dtype)


def qmm_gated_packed_ref(x: Tensor, qw_up: Tensor, sw_up: Tensor,
                         qw_gate: Tensor, sw_gate: Tensor, act, ebits=8,
                         out_dtype=torch.float32) -> Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` against prepacked weights, both GEMMs
    sharing one activation quantization."""
    up = qmm_packed_ref(x, qw_up, sw_up, ebits)
    gate = qmm_packed_ref(x, qw_gate, sw_gate, ebits)
    return (act(gate) * up).to(out_dtype)


def qmm_gated_ref(x: Tensor, w_up: Tensor, w_gate: Tensor, act,
                  block: int = 256, ebits=8, out_dtype=torch.float32) -> Tensor:
    """On-the-fly variant of :func:`qmm_gated_packed_ref`."""
    qu = quantize_block(w_up.t().to(torch.float32), block)
    qg = quantize_block(w_gate.t().to(torch.float32), block)
    return qmm_gated_packed_ref(x, qu.values, qu.scales, qg.values, qg.scales,
                                act, ebits, out_dtype)
