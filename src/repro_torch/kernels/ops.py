"""approx_matmul: the single dispatch point between model code and the
approximation techniques (DESIGN.md §3).

  EXACT   plain matmul with f32 accumulation (baseline)
  AXQ     block-quantized int8 GEMM with a runtime effective-bits degree —
          the CUDA kernels on the card, their plain versions on the CPU
          (kernels/dispatch.py)

The emulation modes (PR/RAD/ROUP_EMUL), POW2_W, the int8 ring
tensor-parallel route and the bf16-backward lever are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.approx import ApproxMode, ApproxSpec
from repro_torch.kernels import qstore

Tensor = torch.Tensor


def _degree_for(spec: ApproxSpec, degree):
    return degree if (spec.dynamic and degree is not None) else spec.ebits


def approx_matmul(x: Tensor, w, spec: ApproxSpec | None = None, *,
                  degree=None, out_dtype=None, path: str = "",
                  bias: Optional[Tensor] = None,
                  residual: Optional[Tensor] = None) -> Tensor:
    """x (..., K) @ w through the approximation dispatch.

    ``w``: a (K, N) float tensor or, for AXQ, a prepacked
    :class:`~repro_torch.kernels.qstore.PackedQWeight`.  ``degree`` is the
    runtime DyFXU knob (device int32) used by dynamic AXQ specs.  ``bias``
    (N,) and ``residual`` (..., N) are AXQ-only epilogue operands, added in
    f32 before the output cast (in the kernel on the card)."""
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
    if spec.mode == ApproxMode.EXACT:
        if packed:
            raise ValueError(
                f"prepacked weight reached an EXACT spec at {path!r} — the "
                "prepack policy and the apply policy disagree")
        # operands in the working dtype, products accumulated in f32
        y = torch.matmul(x2.to(torch.float32), w.to(x2.dtype).to(torch.float32))
    elif spec.mode == ApproxMode.AXQ:
        res2 = None if residual is None else residual.reshape(-1, N)
        y = kdispatch.axq_matmul(x2, w, block=spec.block,
                                 ebits=_degree_for(spec, degree),
                                 bias=bias, residual=res2)
    else:
        raise NotImplementedError(f"approx mode {spec.mode.value} is not ported")
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
