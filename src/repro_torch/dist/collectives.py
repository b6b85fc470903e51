"""Approximation-compressed collectives, single-device part (the port of
``repro.dist.collectives``' quantization primitives).

The dissertation trades arithmetic exactness for energy and area with a
runtime degree; the same trade on the interconnect moves gradients as int8
on the wire, with error feedback keeping optimization unbiased.  On one
device the data-parallel all-reduce is the identity, so
:func:`dp_allreduce_compressed` is the quantize-dequantize of the local
contribution — what the reference's pjit path does before the partitioner's
all-reduce.  The int8 ring all-reduce (shard_map) is not ported.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_map

Tensor = torch.Tensor


def quantize_dequantize(x: Tensor, bits: int = 8) -> Tensor:
    """Symmetric per-tensor fake-quantization to ``bits`` (round to
    nearest, ties to even): error at most ``amax / qmax / 2``."""
    qmax = float((1 << (bits - 1)) - 1)
    x32 = x.to(torch.float32)
    amax = torch.clamp(torch.max(torch.abs(x32)), min=1e-30)
    scale = amax / qmax
    q = torch.clamp(torch.round(x32 / scale), -qmax, qmax)
    return (q * scale).to(x.dtype)


def ef_compress(g: Tensor, err: Tensor, bits: int = 8) -> tuple[Tensor, Tensor]:
    """Error-feedback compression: send the quantized (gradient + carried
    residual), carry the new residual.  ``sum(sent) + err_final ==
    sum(g_true)`` telescopes, so the residual stays within one step."""
    acc = g.to(torch.float32) + err.to(torch.float32)
    sent = quantize_dequantize(acc, bits)
    return sent, acc - sent


def dp_allreduce_compressed(x: Tensor, bits: int = 8) -> Tensor:
    """The data-parallel all-reduce with int-``bits`` wire emulation: on one
    device the quantize-dequantize of the local contribution."""
    return quantize_dequantize(x, bits)


def compress_tree_for_allreduce(grads, bits: int = 8):
    """:func:`dp_allreduce_compressed` on every matrix-shaped gradient; 1-d
    leaves (norm scales, biases) pass exactly."""
    return tree_map(lambda g: dp_allreduce_compressed(g, bits) if g.dim() >= 2 else g,
                    grads)
