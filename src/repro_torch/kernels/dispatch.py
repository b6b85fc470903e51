"""Kernel backend dispatch: the single routing point between the model call
sites and the CUDA kernels (DESIGN.md §8).

Backend selection — ``REPRO_TORCH_KERNELS``, overridable per process with
:func:`set_backend` (``launch.serve --kernels``):

  auto   the kernel for a CUDA tensor, the plain PyTorch version for a CPU
         tensor (default);
  cuda   the kernel; a CPU tensor raises;
  torch  the plain PyTorch versions on any device — an explicit choice for
         comparisons (``chip_smoke.py``), never a fallback.

On a CUDA tensor, ``auto`` and ``cuda`` launch the kernel or raise: there
is no silent fallback, and a card other than sm_90 raises in the kernel
wrapper.

Routers: :func:`prefill_attention` (full-sequence GQA attention, model
layout), :func:`decode_attention` (one-token decode against a KVCache or a
QuantKVCache), :func:`axq_matmul` / :func:`axq_gated` (AXQ projections;
prepacked weights take the quantize-once inference path, float weights a
differentiable ``torch.autograd.Function`` with a kernel forward and a
``qmm_ref`` — or straight-through — backward), :func:`fir` /
:func:`conv2d` / :func:`fir_approx` (the Ch. 7 DSP cores on the PR
multiplier kernel).  ``last_route`` records the backend each call site
took.

Runtime degree contract: every router takes the DyFXU degree as a device
int32 (a global scalar or one element of a per-site vector,
:func:`site_degree`), whose address the kernels read — moving it never
rebuilds, recompiles or syncs.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.core.quantization import qmm_gated_ref, qmm_ref
from repro_torch.kernels import axqmm as _axq
from repro_torch.kernels.flash_attention import (flash_attention_grouped,
                                                 flash_attention_grouped_plain)
from repro_torch.kernels.flash_decode import decode_attn_flash
from repro_torch.kernels.qstore import PackedQWeight, resolve_block

Tensor = torch.Tensor

_VALID = ("auto", "cuda", "torch")

_override: Optional[str] = None

#: last routing decision per call site ("prefill" / "decode" attention,
#: "gemm" / "gated" AXQ projections)
last_route: dict = {}


def _record_route(site: str, backend: str) -> None:
    last_route[site] = backend


def set_backend(name: Optional[str]) -> None:
    """Process-wide override of ``REPRO_TORCH_KERNELS`` (None -> back to
    the environment)."""
    global _override
    if name is not None and name not in _VALID:
        raise ValueError(f"backend must be one of {_VALID}, got {name!r}")
    _override = name


def backend_setting() -> str:
    setting = _override or os.environ.get("REPRO_TORCH_KERNELS", "auto")
    if setting not in _VALID:
        raise ValueError(
            f"REPRO_TORCH_KERNELS must be one of {_VALID}, got {setting!r}")
    return setting


def resolved_backend(device=None) -> str:
    """'cuda' or 'torch' for tensors on ``device`` after resolving 'auto'.
    ``cuda`` with a CPU device raises."""
    setting = backend_setting()
    dev = torch.device(device) if device is not None else None
    if setting == "auto":
        return "cuda" if dev is not None and dev.type == "cuda" else "torch"
    if setting == "cuda" and dev is not None and dev.type != "cuda":
        raise RuntimeError(
            "kernel backend 'cuda' was requested for a tensor on the CPU")
    return setting


def site_degree(degree, site: int):
    """Index a per-site degree vector down to one site's scalar: a view,
    whose device address is what the kernels read.  None and scalars pass
    through."""
    if degree is None:
        return None
    if isinstance(degree, Tensor) and degree.ndim:
        return degree[site]
    return degree


# ---------------------------------------------------------------------------
# attention routers
# ---------------------------------------------------------------------------


def prefill_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      window: Optional[int] = None) -> Tensor:
    """Full-sequence GQA attention, model layout: q (B, S, H, D), k/v
    (B, S, KVr, D) -> (B, S, H, D).  The kernel reads the grouped K/V
    directly (no repeat to all heads)."""
    if window is not None and window < q.shape[1]:
        raise NotImplementedError(
            "sliding-window prefill (the band schedule) is not ported yet")
    backend = resolved_backend(q.device)
    _record_route("prefill", backend)
    if backend == "cuda":
        return flash_attention_grouped(q, k, v, causal=causal)
    return flash_attention_grouped_plain(q, k, v, causal=causal)


def decode_attention(q1: Tensor, knew: Tensor, vnew: Tensor, cache, *,
                     window: Optional[int] = None, degree=None, active=None):
    """Single-token decode against the KV cache (updated in place):
    q1 (B, 1, H, D), knew/vnew (B, 1, KVr, D) -> (out (B, 1, H, D), cache).
    A :class:`~repro_torch.models.attention.KVCache` takes ``flash_decode``,
    a ``QuantKVCache`` ``flash_decode_quant``, whose dequantization reads
    ``degree`` (the layer's site degree, a device int32) by address."""
    from repro_torch.models.attention import KVCache, QuantKVCache

    if not isinstance(cache, (KVCache, QuantKVCache)):
        raise TypeError(f"decode against {type(cache).__name__}: expected a "
                        "KVCache or QuantKVCache")
    backend = resolved_backend(q1.device)
    _record_route("decode", backend)
    return decode_attn_flash(q1, knew, vnew, cache, window=window,
                             active=active, degree=degree,
                             plain=backend == "torch")


# ---------------------------------------------------------------------------
# GEMM routing (AXQ projections — DESIGN.md §9)
# ---------------------------------------------------------------------------


def _ste_mm(a: Tensor, b: Tensor) -> Tensor:
    """bf16 operands, f32 accumulation (the straight-through backward)."""
    return torch.matmul(a.to(torch.bfloat16).to(torch.float32),
                        b.to(torch.bfloat16).to(torch.float32))


class _AxqMatmul(torch.autograd.Function):
    """Float-weight AXQ matmul: kernel (or plain) forward; backward through
    the ``qmm_ref`` oracle, or straight-through exact matmul for ``ste``."""

    @staticmethod
    def forward(ctx, x, w, e, block, plain, ste):
        ctx.save_for_backward(x, w)
        ctx.e, ctx.block, ctx.ste = e, block, ste
        return _axq.axqmm(x, w, block=block, ebits=e, plain=plain)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        if ctx.ste:
            dx = _ste_mm(g, w.t()).to(x.dtype)
            dw = _ste_mm(x.t(), g).to(w.dtype)
        else:
            with torch.enable_grad():
                xx = x.detach().requires_grad_()
                ww = w.detach().requires_grad_()
                y = qmm_ref(xx, ww, block=ctx.block, ebits=ctx.e)
                dx, dw = torch.autograd.grad(y, (xx, ww), g, allow_unused=True)
            dx = torch.zeros_like(x) if dx is None else dx
            dw = torch.zeros_like(w) if dw is None else dw
        return dx, dw, None, None, None, None


class _AxqGated(torch.autograd.Function):
    """Float-weight fused gated AXQ core (see :class:`_AxqMatmul`)."""

    @staticmethod
    def forward(ctx, x, wu, wg, e, block, act, plain, ste):
        ctx.save_for_backward(x, wu, wg)
        ctx.e, ctx.block, ctx.act, ctx.ste = e, block, act, ste
        return _axq.axqmm_gated(x, wu, wg, block=block, ebits=e, act=act,
                                plain=plain)

    @staticmethod
    def backward(ctx, g):
        x, wu, wg = ctx.saved_tensors
        actf = _axq.ACTS[ctx.act]
        with torch.enable_grad():
            xx, wuu, wgg = (t.detach().requires_grad_() for t in (x, wu, wg))
            if ctx.ste:
                y = actf(xx @ wgg) * (xx @ wuu)
            else:
                y = qmm_gated_ref(xx, wuu, wgg, actf, block=ctx.block, ebits=ctx.e)
            grads = torch.autograd.grad(y, (xx, wuu, wgg), g, allow_unused=True)
        grads = [torch.zeros_like(t) if d is None else d.to(t.dtype)
                 for d, t in zip(grads, (x, wu, wg))]
        return (*grads, None, None, None, None, None)


def axq_matmul(x2: Tensor, w, *, block: int = 256, ebits=8,
               bias: Optional[Tensor] = None, residual: Optional[Tensor] = None,
               ste: bool = False) -> Tensor:
    """AXQ GEMM router: x2 (M, K) @ w -> (M, N) f32.

    ``w`` is a :class:`PackedQWeight` (inference: bias/residual fuse into
    the kernel epilogue) or a float (K, N) tensor (trainable: quantized on
    the fly; bias/residual are the same ordered f32 adds after)."""
    backend = resolved_backend(x2.device)
    _record_route("gemm", backend)
    x2 = x2.to(torch.float32)
    if isinstance(w, PackedQWeight):
        if backend == "cuda":
            return _axq.axqmm_packed(x2, w, ebits, bias=bias, residual=residual)
        return _axq.axqmm_packed_plain(x2, w, ebits, bias=bias, residual=residual)
    blk = resolve_block(x2.shape[-1], block)
    y = _AxqMatmul.apply(x2, w.to(torch.float32), ebits, blk,
                         backend == "torch", ste)
    if bias is not None:
        y = y + bias.to(torch.float32)[None, :]
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y


def axq_gated(x2: Tensor, w_up, w_gate, *, act: str = "silu",
              block: int = 256, ebits=8, ste: bool = False) -> Tensor:
    """Fused gated-MLP first half ``act(x @ w_gate) * (x @ w_up)``; same
    packed-vs-float contract as :func:`axq_matmul`."""
    backend = resolved_backend(x2.device)
    _record_route("gated", backend)
    x2 = x2.to(torch.float32)
    if isinstance(w_up, PackedQWeight):
        if backend == "cuda":
            return _axq.axqmm_gated_packed(x2, w_up, w_gate, ebits, act=act)
        return _axq.axqmm_gated_plain(x2, w_up, w_gate, ebits, act=act)
    blk = resolve_block(x2.shape[-1], block)
    return _AxqGated.apply(x2, w_up.to(torch.float32), w_gate.to(torch.float32),
                           ebits, blk, act, backend == "torch", ste)


# ---------------------------------------------------------------------------
# DSP routing (approximate FIR / conv2d — the Ch. 7 accelerators)
# ---------------------------------------------------------------------------


def _pr_knobs(degree, p, r, device) -> Tensor:
    """Resolve the PR knobs to the (p, r) operand the kernel reads: either
    a ladder ``degree`` (effective bits, mapped on the device by
    ``dsp.degree_to_pr``) or explicit raw integer (p, r) — not both."""
    from repro_torch.kernels import dsp as _dsp

    if degree is not None:
        if p is not None or r is not None:
            raise ValueError("pass either degree= or explicit p=/r=, not both")
        return _dsp.degree_to_pr(degree, device=device)
    return (0 if p is None else int(p), 0 if r is None else int(r))


def fir(x, taps, *, tail=None, degree=None, p=None, r=None, n: int = 16,
        shift: int = 0):
    """Approximate-FIR router (DyFXU PR datapath): the ``pr_multiply``
    kernel or its plain version, selected like every other site
    (``REPRO_TORCH_KERNELS`` / :func:`set_backend`, by the tensors'
    device), recorded under ``last_route["fir"]``.

    Two call modes (int32 operands; the float/differentiable entry is
    :func:`fir_approx`):

    * offline / valid-mode (``tail=None``): ``x`` is a whole (L,) signal;
      host-side int64 accumulation (arbitrary Q14 operands), returns a
      numpy (L - T,) array.  Benchmarks and examples.
    * streaming (``tail`` given): ``x`` (B, L) frame batch, ``tail``
      (B, T-1) carried history; int32 accumulation (taps l1 norm <=
      ``2**shift``), returns ``(y, new_tail)``.  The serve engine.

    ``degree`` is the ladder knob (None = exact, a device int32 = runtime
    rung); raw (p, r) may be passed instead for sweep-style benches."""
    from repro_torch.kernels import dsp as _dsp

    x = torch.as_tensor(x)
    backend = resolved_backend(x.device)
    _record_route("fir", backend)
    pr = _pr_knobs(degree, p, r, x.device)
    if tail is None:
        return _dsp.fir_valid(x, taps, pr, n=n, plain=backend == "torch")
    return _dsp.fir_frames(x, tail, taps, pr, n=n, shift=shift,
                           plain=backend == "torch")


def conv2d(img, kern, *, degree=None, p=None, r=None, n: int = 16,
           shift: int = 0, pad: str = "zero"):
    """Approximate-conv2d router (same-size 2D correlation on the PR
    datapath): img (B, H, W) int32, kern (kh, kw) int32 with l1 norm <=
    ``2**shift``; recorded under ``last_route["conv2d"]``.  Same
    degree/knob contract as :func:`fir`."""
    from repro_torch.kernels import dsp as _dsp

    img = torch.as_tensor(img)
    backend = resolved_backend(img.device)
    _record_route("conv2d", backend)
    pr = _pr_knobs(degree, p, r, img.device)
    return _dsp.conv2d_pr(img, kern, pr, n=n, shift=shift, pad=pad,
                          plain=backend == "torch")


class _FirApprox(torch.autograd.Function):
    """Differentiable float FIR core: quantize -> PR streaming FIR (kernel
    or plain) -> dequantize forward; the exact-correlation straight-through
    backward (the PR bit surgery is piecewise-constant).  The integer
    knobs get no gradient."""

    @staticmethod
    def forward(ctx, x, t, pr, q, n, plain):
        from repro_torch.kernels import dsp as _dsp

        scale = float(1 << q)
        lim = float((1 << (n - 1)) - 1)
        xq = torch.clamp(torch.round(x * scale), -lim, lim).to(torch.int32)
        tq = torch.clamp(torch.round(t * scale), -lim, lim).to(torch.int32)
        tail = torch.zeros((x.shape[0], t.shape[0] - 1), dtype=torch.int32,
                           device=x.device)
        y, _ = _dsp.fir_frames(xq, tail, tq, pr, n=n, shift=0, plain=plain)
        ctx.save_for_backward(x, t)
        return y.to(torch.float32) / (scale * scale)

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            tt = t.detach().requires_grad_()
            dx, dt = torch.autograd.grad(_fir_exact(xx, tt), (xx, tt), g)
        return dx, dt, None, None, None, None


def _fir_exact(x: Tensor, t: Tensor) -> Tensor:
    """Exact zero-history causal correlation ``y[b, l] = sum_i t[i] *
    x[b, l + i - (T - 1)]`` in float."""
    T = t.shape[0]
    ext = torch.cat([x.new_zeros((x.shape[0], T - 1)), x], dim=1)
    win = torch.stack([ext[:, i:i + x.shape[1]] for i in range(T)])
    return torch.einsum("i,ibl->bl", t, win)


def fir_approx(x: Tensor, taps: Tensor, *, degree=None, q: int = 12,
               n: int = 16) -> Tensor:
    """Differentiable float FIR entry: x (B, L) f32 in ~[-1, 1], taps (T,)
    f32 with |l1| <~ 1 (so Q-``q`` products fit int32 lanes).  Zero-history
    causal filtering; forward runs the int PR datapath, backward is the
    exact correlation (STE)."""
    backend = resolved_backend(x.device)
    _record_route("fir", backend)
    pr = _pr_knobs(degree, None, None, x.device)
    return _FirApprox.apply(x.to(torch.float32), taps.to(torch.float32), pr, q,
                            n, backend == "torch")
