"""The kernels' entries as ops of torch's dispatcher (namespace
``repro_torch``), each with a fake implementation: the shape and dtype of
the kernel's output, from its operands' shapes, and no data.

A ``meta`` tensor (shapes and dtypes, nothing computed: the dry run of
``dist/hlo_analysis.py``) reaches a kernel through these ops.  The routers
of ``kernels/dispatch.py`` and the wrappers hand it here at the point where
a CUDA tensor launches the kernel and a CPU tensor takes the plain version,
so a dispatch mode sees each kernel call as the op it is: the analysis
keeps the work of each op in one table (``hlo_analysis._KERNEL_WORK``).
The ops have no CPU or CUDA implementation, so a tensor with data that
reached one would raise; the launch path never goes through the
dispatcher (no cost a launch).  The same fake implementations serve any
tracer that runs on fake tensors.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_LIB = torch.library.Library("repro_torch", "DEF")


def _op(schema: str):
    """Define ``repro_torch::<schema>`` with the decorated function as its
    fake implementation; returns the op."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)

    def register(fake):
        torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
        return getattr(torch.ops.repro_torch, name)

    return register


def _same_k(x: Tensor, *qws: Tensor) -> None:
    for qw in qws:
        if qw.shape[-1] != x.shape[-1]:
            raise ValueError(f"packed K={qw.shape[-1]} but x has K={x.shape[-1]}")


@_op("axqmm(Tensor x, Tensor qw) -> Tensor")
def axqmm(x, qw):
    """x (M, K) @ an int8 pack qw (N, K) -> (M, N) f32."""
    _same_k(x, qw)
    return x.new_empty((x.shape[0], qw.shape[-2]), dtype=torch.float32)


@_op("axqmm_gated(Tensor x, Tensor qw_up, Tensor qw_gate) -> Tensor")
def axqmm_gated(x, qw_up, qw_gate):
    """The fused gated core of x (M, K) and two packs (N, K) -> (M, N) f32."""
    _same_k(x, qw_up, qw_gate)
    return x.new_empty((x.shape[0], qw_up.shape[-2]), dtype=torch.float32)


@_op("axqmm_experts(Tensor x, Tensor qw) -> Tensor")
def axqmm_experts(x, qw):
    """x (E, C, K) @ each expert's pack qw (E, N, K) -> (E, C, N) f32."""
    _same_k(x, qw)
    return x.new_empty((x.shape[0], x.shape[1], qw.shape[-2]), dtype=torch.float32)


@_op("axqmm_gated_experts(Tensor x, Tensor qw_up, Tensor qw_gate) -> Tensor")
def axqmm_gated_experts(x, qw_up, qw_gate):
    """Each expert's fused gated core, x (E, C, K) -> (E, C, N) f32."""
    _same_k(x, qw_up, qw_gate)
    return x.new_empty((x.shape[0], x.shape[1], qw_up.shape[-2]), dtype=torch.float32)


@_op("flash_attention(Tensor q, Tensor k, Tensor v, int? window) -> Tensor")
def flash_attention(q, k, v, window):
    """Grouped prefill attention, model layout: q (B, S, H, D), k / v
    (B, S_kv, KVr, D) -> q's shape and dtype."""
    return torch.empty_like(q)


@_op("flash_decode(Tensor qg, Tensor k) -> Tensor")
def flash_decode(qg, k):
    """One decode token, grouped qg (B, KVr, G, D), against a cache whose
    keys are k (B, T, KVr, D), either cache's -> (B, KVr, G, D) f32."""
    return torch.empty_like(qg, dtype=torch.float32)


@_op("fir_valid(Tensor x, Tensor taps) -> Tensor")
def fir_valid(x, taps):
    """Valid-mode FIR of a whole signal x (L,) -> (L - T,) int64."""
    return x.new_empty((x.shape[0] - taps.shape[0],), dtype=torch.int64)


@_op("pr_fir(Tensor x, Tensor taps, Tensor tail) -> (Tensor, Tensor)")
def pr_fir(x, taps, tail):
    """Streaming FIR of frames x (B, L) and their history tail (B, T - 1)
    -> (y, new tail), int32."""
    return (torch.empty_like(x, dtype=torch.int32),
            torch.empty_like(tail, dtype=torch.int32))


@_op("pr_conv2d(Tensor img, Tensor kern) -> Tensor")
def pr_conv2d(img, kern):
    """2-D convolution of images (B, H, W) by kern (kh, kw), same size ->
    int32."""
    return torch.empty_like(img, dtype=torch.int32)
