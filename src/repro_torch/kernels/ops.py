"""approx_matmul: the single dispatch point between model code and the
approximation techniques (DESIGN.md §3).

  EXACT      plain matmul with f32 accumulation (baseline)
  AXQ        block-quantized int8 GEMM with a runtime effective-bits degree —
             the CUDA kernels on the card, their plain versions on the CPU
             (kernels/dispatch.py)
  PR_EMUL    bit-exact AxFXU emulation: per-tensor int8 quantization, the
             operand transforms (round the activation, perforate the
             weight), an exact integer product, dequantization.  PR
             transforms each operand on its own, so the approximate
             product-sum equals the exact product of transformed operands.
  RAD_EMUL   the same with the hybrid high-radix encoding on the weight
  ROUP_EMUL  both
  POW2_W     weights snapped to powers of two

The *_EMUL product is an int32 integer product of int8 operands (exact for
K <= 2^17): a plain integer ``torch.matmul`` on the CPU, ``torch._int_mm``
on the card (cuBLASLt's int8 GEMM; no TPU kernel computes these modes,
the reference's product is an integer ``jnp.matmul``).

``REPRO_BWD_BF16=1`` (read at import, as in the reference) routes the EXACT
products through :class:`_MatmulBf16Bwd`: bf16 partials forward and bf16
activation gradients, the weight gradient accumulated in f32.

Tensor parallelism (a mesh whose ``model`` axis is wider than 1,
``dist/meshctx.py``): ``approx_matmul`` returns the global value, as the
reference's does under GSPMD.  A row-parallel projection (a path ending in
``/wo``, ``/down`` or ``/out_proj``: its weight is this rank's rows of K)
computes its f32 partial and sums it over the ``model`` group through
``collectives.reduce_from_model`` (whose backward is the identity, so the
same code trains); an AXQ bias and residual are then added in f32 once,
after the reduction, and the sum is cast (on one device they ride the
kernel's epilogue in the same order: f32 accumulate, + bias, + residual,
cast).  A float AXQ shard is quantized in the blocks of the global K
(``qstore.row_block``; a shard that is not a whole number of them raises).
Under :func:`ring_tp` (or ``REPRO_RING_TP=1``) the EXACT projections take
the reference's int8-ring forms: a row-parallel partial is reduced through
the int8 ring all-reduce (``_RingTpMatmul``; its backward is local), and a
column-parallel projection (``/wq``, ``/wk``, ``/wv``, ``/up``, ``/gate``,
``unembed``) is the plain product whose backward sends its dx partial
through the ring, one projection at a time (``_RingDxMatmul``; the model
then skips the exact dx all-reduce of that input, ``layers.column_input``).
Under AXQ the ring stays off.  The *_EMUL modes quantize per tensor, and a
shard's scale is not the whole tensor's: they raise on a mesh.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

from repro_torch.core import encodings as enc
from repro_torch.core.approx import ApproxMode, ApproxSpec
from repro_torch.dist import collectives, meshctx
from repro_torch.dist.sharding import is_row_parallel
from repro_torch.kernels import qstore

Tensor = torch.Tensor

#: cuBLASLt's int8 GEMM wants more than this many rows: a decode-sized
#: activation is zero-padded to INT_MM_PAD_M rows (after quantization, so
#: the pad never enters the per-tensor amax)
INT_MM_MIN_M = 16
INT_MM_PAD_M = 32


#: the bf16-backward lever: the activation-gradient partial sums in bf16
#: (half the bytes of a tensor-parallel all-reduce of dx in the reference)
_BWD_BF16 = os.environ.get("REPRO_BWD_BF16", "0") == "1"


class _MatmulBf16Bwd(torch.autograd.Function):
    """``x2 @ w`` with bf16 operands and bf16 output partials; backward: dx
    from bf16 partials (cast to x2's dtype), dw accumulated in f32 (cast to
    w's dtype)."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return torch.matmul(x2.to(torch.bfloat16), w.to(torch.bfloat16))

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        dx = torch.matmul(g16, w.to(torch.bfloat16).t()).to(x2.dtype)
        dw = torch.matmul(x2.to(torch.bfloat16).t().to(torch.float32),
                          g16.to(torch.float32)).to(w.dtype)
        return dx, dw


# the int8-ring lever: route the tensor-parallel output reductions (the
# row-parallel projections' partials) through the int8 ring all-reduce
_RING_TP = os.environ.get("REPRO_RING_TP", "0") == "1"


@contextlib.contextmanager
def ring_tp(enabled: bool = True):
    """Scoped ``REPRO_RING_TP``: route the EXACT tensor-parallel output
    reductions through the int8 ring while the context is open (the
    sharded serve engine opens it around each tick when ``ring=True``)."""
    global _RING_TP
    prev = _RING_TP
    _RING_TP = bool(enabled)
    try:
        yield
    finally:
        _RING_TP = prev


class _RingTpMatmul(torch.autograd.Function):
    """A row-parallel EXACT product reduced through the int8 ring: the
    local f32 partial ``x2 @ w`` (this rank's K rows), then
    :func:`~repro_torch.dist.collectives.ring_allreduce_int8` over the
    ``model`` group.  Backward (the reference's ``_ring_bwd``): the local
    dx and dw, no collective (dx is this rank's K columns; the cotangent
    is replicated)."""

    @staticmethod
    def forward(ctx, x2, w, group):
        ctx.save_for_backward(x2, w)
        acc = torch.matmul(x2.to(torch.float32), w.to(x2.dtype).to(torch.float32))
        return collectives.ring_allreduce_int8(acc, group)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g32 = g.to(torch.float32)
        dx = torch.matmul(g32, w.to(torch.float32).t()).to(x2.dtype)
        dw = torch.matmul(x2.to(torch.float32).t(), g32).to(w.dtype)
        return dx, dw, None


class _RingDxMatmul(torch.autograd.Function):
    """A column-parallel EXACT product (x replicated, w this rank's
    columns): the plain product forward; backward (the reference's
    ``_ring_dx_bwd``): dw local, the dx partial ``g @ w.T`` summed over
    the ``model`` group through the int8 ring."""

    @staticmethod
    def forward(ctx, x2, w, group):
        ctx.save_for_backward(x2, w)
        ctx.group = group
        return torch.matmul(x2.to(torch.float32), w.to(x2.dtype).to(torch.float32))

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g32 = g.to(torch.float32)
        dw = torch.matmul(x2.to(torch.float32).t(), g32).to(w.dtype)
        part = torch.matmul(g32, w.to(torch.float32).t())
        dx = collectives.ring_allreduce_int8(part, ctx.group).to(x2.dtype)
        return dx, dw, None


#: the column-parallel paths whose dx goes through the ring under ring_tp
RING_DX_PATHS = ("/wq", "/wk", "/wv", "/up", "/gate", "unembed")


def ring_dx_path(path: str, spec: Optional[ApproxSpec]) -> bool:
    """Whether the column-parallel projection at ``path`` sends its dx
    through the int8 ring (:func:`ring_tp` open, EXACT, a mesh whose
    ``model`` axis is wider than 1)."""
    return (_RING_TP and (spec is None or spec.mode == ApproxMode.EXACT)
            and path.endswith(RING_DX_PATHS) and meshctx.model_size() > 1)


def _ring_tp_matmul(x2: Tensor, w: Tensor) -> Tensor:
    """:class:`_RingTpMatmul` over the ``model`` group (the plain product
    on a 1-wide axis)."""
    mesh = meshctx.get_mesh()
    if mesh.size("model") == 1:
        return torch.matmul(x2.to(torch.float32), w.to(x2.dtype).to(torch.float32))
    return _RingTpMatmul.apply(x2, w, mesh.group("model"))


def _degree_for(spec: ApproxSpec, degree):
    return degree if (spec.dynamic and degree is not None) else spec.ebits


def _quantize_per_tensor(x: Tensor, bits: int):
    """Symmetric per-tensor quantization: (int32 codes, f32 0-d scale)."""
    qmax = (1 << (bits - 1)) - 1
    amax = torch.clamp(x.abs().amax(), min=1e-30)
    scale = amax / qmax
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    return q, scale


def pad_for_int_mm(qx: Tensor) -> Tensor:
    """``qx`` (M, K) int8 with M <= 16 zero-padded to 32 rows (cuBLASLt's
    int8 GEMM wants M > 16); larger M unchanged."""
    M, K = qx.shape
    if M <= INT_MM_MIN_M:
        return torch.cat([qx, qx.new_zeros(INT_MM_PAD_M - M, K)])
    return qx


def int_product(qx: Tensor, qw: Tensor) -> Tensor:
    """Exact int32 product of int8 ``qx`` (M, K) and ``qw`` (K, N): a plain
    integer matmul on the CPU, ``torch._int_mm`` on the card (``qw``
    column-major, as :func:`~repro_torch.kernels.qstore.emul_layout` stores
    it; a decode-sized ``qx`` padded by :func:`pad_for_int_mm`).  No host
    read: it runs inside a captured step.  On meta tensors (the dry run)
    it takes the card's form, so the analysis counts what the card runs."""
    if qx.device.type not in ("cuda", "meta"):
        return torch.matmul(qx.to(torch.int32), qw.to(torch.int32))
    K, N = qw.shape
    if K % 8 or N % 8:
        raise ValueError(f"torch._int_mm needs K and N multiples of 8, got K={K}, N={N}")
    return torch._int_mm(pad_for_int_mm(qx), qw)[:qx.shape[0]]


def _emul_matmul_packed(x: Tensor, pw, spec: ApproxSpec) -> Tensor:
    """Exact integer product against a prepacked (quantized, transformed)
    emulation weight; only the activation is quantized / rounded per call.
    The int8 cast wraps as the reference's does (a rounded 128 is -128)."""
    n = spec.lane_bits
    assert n <= 8, "in-graph emulation lane limited to 8 bits (see module doc)"
    qx, sx = _quantize_per_tensor(x, n)
    if spec.mode in (ApproxMode.PR_EMUL, ApproxMode.ROUP_EMUL):
        qx = enc.round_operand(qx, spec.r)
    acc = int_product(qx.to(torch.int8), pw.qw)
    return acc.to(torch.float32) * (sx * pw.scale)


def _emul_matmul(x: Tensor, w, spec: ApproxSpec) -> Tensor:
    """Float weights are packed on the fly through the same quantize and
    transform the prepack runs once: prepacked and on-the-fly products are
    bit-identical by construction."""
    if not isinstance(w, qstore.PackedEmulWeight):
        w = qstore.prepack_emul_weight(w, spec)
    return _emul_matmul_packed(x, w, spec)


def approx_matmul(x: Tensor, w, spec: ApproxSpec | None = None, *,
                  degree=None, out_dtype=None, path: str = "",
                  bias: Optional[Tensor] = None,
                  residual: Optional[Tensor] = None) -> Tensor:
    """x (..., K) @ w through the approximation dispatch.

    ``w``: a (K, N) float tensor or a prepacked
    :class:`~repro_torch.kernels.qstore.PackedQWeight` (AXQ) /
    :class:`~repro_torch.kernels.qstore.PackedEmulWeight` (*_EMUL).  ``degree`` is the
    runtime DyFXU knob (device int32) used by dynamic AXQ specs.  ``bias``
    (N,) and ``residual`` (..., N) are AXQ-only epilogue operands, added in
    f32 before the output cast (in the kernel on the card).  On a mesh a
    row-parallel ``path`` returns the reduced global value (module
    docstring)."""
    from repro_torch.kernels import dispatch as kdispatch  # lazy: import cycle

    spec = spec or ApproxSpec()
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    packed = qstore.is_packed(w)
    N = w.n if packed else w.shape[-1]
    if spec.mode != ApproxMode.AXQ and (bias is not None or residual is not None):
        raise ValueError("bias/residual epilogues are AXQ-only (fused path)")
    mesh = meshctx.get_mesh()
    row = mesh.size("model") > 1 and is_row_parallel(path)
    if mesh.size("model") > 1 and spec.mode in qstore._EMUL_MODES:
        raise NotImplementedError(
            f"{spec.mode.value} at {path!r} on a mesh: a shard's per-tensor scale is not "
            "the whole tensor's")
    if spec.mode == ApproxMode.EXACT:
        if packed:
            raise ValueError(
                f"prepacked weight reached an EXACT spec at {path!r} — the "
                "prepack policy and the apply policy disagree")
        if _RING_TP and is_row_parallel(path):
            y = _ring_tp_matmul(x2, w)
            row = False                      # reduced by the ring
        elif ring_dx_path(path, spec):
            y = _RingDxMatmul.apply(x2, w, mesh.group("model"))
        elif _BWD_BF16:
            y = _MatmulBf16Bwd.apply(x2, w)
        else:
            # operands in the working dtype, products accumulated in f32
            y = torch.matmul(x2.to(torch.float32), w.to(x2.dtype).to(torch.float32))
    elif spec.mode == ApproxMode.AXQ:
        if packed and not isinstance(w, qstore.PackedQWeight):
            raise ValueError(f"AXQ spec at {path!r} got {type(w).__name__}")
        res2 = None if residual is None else residual.reshape(-1, N)
        if row:
            # the partial carries no epilogue: bias and residual are added
            # once, after the reduction; a float shard takes the global K's
            # blocks (a pack already has them)
            block = spec.block if packed else qstore.row_block(
                f"{path}/w", K, mesh.size("model"), spec.block)
            y = kdispatch.axq_matmul(x2, w, block=block, ebits=_degree_for(spec, degree))
            y = collectives.reduce_from_model(y, mesh.group("model"))
            if bias is not None:
                y = y + bias.to(torch.float32)[None, :]
            if res2 is not None:
                y = y + res2.to(torch.float32)
            row = False
        else:
            y = kdispatch.axq_matmul(x2, w, block=spec.block,
                                     ebits=_degree_for(spec, degree),
                                     bias=bias, residual=res2)
    elif spec.mode in qstore._EMUL_MODES:
        if packed and not isinstance(w, qstore.PackedEmulWeight):
            raise ValueError(f"emul spec at {path!r} got {type(w).__name__}")
        y = _emul_matmul(x2.to(torch.float32), w, spec)
    elif spec.mode == ApproxMode.POW2_W:
        if packed:
            raise ValueError(f"prepacked weight reached a POW2_W spec at {path!r}")
        w2 = enc.pow2_snap(w.to(torch.float32)).to(x2.dtype)
        y = torch.matmul(x2.to(torch.float32), w2.to(torch.float32))
    else:
        raise ValueError(spec.mode)
    if row:
        # REPRO_BWD_BF16's bf16 partials cross the wire as bf16
        y = collectives.reduce_from_model(y if _BWD_BF16 else y.to(torch.float32),
                                          mesh.group("model"))
    return y.reshape(*lead, N).to(out_dtype)


def approx_gated_matmul(x: Tensor, w_up, w_gate, spec: ApproxSpec, *,
                        act: str = "silu", degree=None,
                        out_dtype=None) -> Tensor:
    """Fused gated-MLP first half ``act(x @ w_gate) * (x @ w_up)`` through
    the AXQ dispatch — one kernel, one shared x stream."""
    from repro_torch.kernels import dispatch as kdispatch  # lazy: import cycle

    if spec.mode != ApproxMode.AXQ:
        raise ValueError(f"approx_gated_matmul is AXQ-only, got {spec.mode}")
    out_dtype = out_dtype or x.dtype
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    N = w_up.n if qstore.is_packed(w_up) else w_up.shape[-1]
    y = kdispatch.axq_gated(x2, w_up, w_gate, act=act, block=spec.block,
                            ebits=_degree_for(spec, degree))
    return y.reshape(*lead, N).to(out_dtype)
