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
wrapper.  A ``meta`` tensor (shape and dtype, no data: the dry run of
``dist/hlo_analysis.py``) takes the meta route under any setting: where a
CUDA tensor would launch a kernel it calls the kernel's op of
``kernels/meta_ops.py``, which returns the output's shape and dtype (the
routers hold that call for ``fir`` and ``conv2d``; the packed GEMM
wrappers, the attention Function and ``decode_attn_flash`` for the
others); the backward oracles run op by op on meta.  Nothing else
reaches it.

Routers: :func:`prefill_attention` (full-sequence GQA attention, model
layout), :func:`decode_attention` (one-token decode against a KVCache or a
QuantKVCache), :func:`axq_matmul` / :func:`axq_gated` (AXQ projections;
prepacked weights take the quantize-once inference path, float weights a
differentiable ``torch.autograd.Function`` with a kernel forward and a
``qmm_ref`` — or straight-through — backward), :func:`axq_matmul_experts`
/ :func:`axq_gated_experts` (the same for E experts of an MoE layer in one
expert-batched launch), :func:`fir` /
:func:`conv2d` / :func:`fir_approx` (the Ch. 7 DSP cores on the PR
multiplier kernels).  ``last_route`` records the backend each call site
took; a change of a site's backend is published to the metrics registry
and the tracer (:func:`_record_route`).

Runtime degree contract: every router takes the DyFXU degree as a device
int32 (a global scalar or one element of a per-site vector,
:func:`site_degree`), whose address the kernels read — moving it never
rebuilds, recompiles or syncs.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.kernels import _build, axq_grad, meta_ops
from repro_torch.kernels import axqmm as _axq
from repro_torch.kernels.flash_attention import flash_attention_vjp
from repro_torch.kernels.flash_decode import decode_attn_flash
from repro_torch.kernels.qstore import PackedQWeight, prepack_weight, resolve_block

Tensor = torch.Tensor

_VALID = ("auto", "cuda", "torch")

_override: Optional[str] = None

#: last routing decision per call site ("prefill" / "decode" attention,
#: "gemm" / "gated" AXQ projections, "fir" / "conv2d" PR stages)
last_route: dict = {}


def _record_route(site: str, backend: str) -> None:
    """Note one routing decision in ``last_route``.  When a site's backend
    differs from the last one recorded (its first call, or a backend
    switch) the decision is also published: the
    ``repro_kernel_route_trace_total{site,backend}`` counter on the
    process-global metrics registry and a ``kernel_route_trace`` event on
    the global tracer.  The reference publishes at jit trace time; here the
    router runs on every call (~130 a decode tick at full width), so a
    backend change is the analogue of a retrace, and a steady call costs
    one dict lookup.  The serve engine's ``repro_kernel_route_steps_total``
    counts executed steps per backend."""
    if last_route.get(site) != backend:
        from repro_torch.obs import metrics as obs_metrics
        from repro_torch.obs import trace as obs_trace

        obs_metrics.get_registry().counter(
            "repro_kernel_route_trace_total",
            "kernel routing decisions that changed a call site's backend, by "
            "call site and backend", labels=("site", "backend")
        ).labels(site=site, backend=backend).inc()
        obs_trace.event("kernel_route_trace", track="dispatch", site=site,
                        backend=backend)
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
    """'cuda' or 'torch' for tensors on ``device`` after resolving 'auto';
    'meta' for the meta device, under any setting.  ``cuda`` with a CPU
    device raises."""
    setting = backend_setting()
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "meta":
        return "meta"
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


def inject_fault(x: Tensor, fault: Optional[Tensor]) -> Tensor:
    """Resilience fault hook (``repro_torch.resil``): corrupt a batch
    activation ``x`` (slots on the leading axis) with a per-slot ``fault``
    operand — a (slots,) float32 vector, 0.0 = clean, NaN/Inf = corrupt
    that slot.  Float activations take ``x + fault`` (exact for clean
    slots, NaN/Inf for marked ones); integer activations flip the high
    magnitude bit on marked slots (NaN compares unordered, so ``fault != 0``
    holds for it).  ``fault=None`` returns ``x`` untouched."""
    if fault is None:
        return x
    f = fault.to(torch.float32).reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    if x.is_floating_point():
        return x + f.to(x.dtype)
    mask = 1 << (8 * x.element_size() - 2)
    return torch.where(f != 0.0, x ^ mask, x)


# ---------------------------------------------------------------------------
# attention routers
# ---------------------------------------------------------------------------


def prefill_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                      window: Optional[int] = None) -> Tensor:
    """Full-sequence GQA attention, model layout: q (B, S, H, D), k/v
    (B, S, KVr, D) -> (B, S, H, D).  The kernel reads the grouped K/V
    directly (no repeat to all heads); a sliding ``window`` shorter than
    the sequence runs its ``band`` schedule.  Differentiable on both
    devices (:func:`~repro_torch.kernels.flash_attention.flash_attention_vjp`:
    the kernel or plain forward, the oracle's gradients)."""
    backend = resolved_backend(q.device)
    _record_route("prefill", backend)
    return flash_attention_vjp(q, k, v, causal=causal, window=window,
                               plain=backend == "torch")


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
    """Float-weight AXQ matmul: kernel (or plain) forward; backward: the
    ``qmm_ref`` oracle's gradient block by block (``axq_grad``), or the
    straight-through exact matmul for ``ste``; counted as ``axqmm_bwd``."""

    @staticmethod
    def forward(ctx, x, w, e, block, plain, ste):
        ctx.save_for_backward(x, w)
        ctx.e, ctx.block, ctx.ste = e, block, ste
        return _axq.axqmm(x, w, block=block, ebits=e, plain=plain)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        with _build.backward_oracle("axqmm_bwd", x):
            grads = _matmul_grads(x, w, g, ctx.e, ctx.block, ctx.ste)
        return (*grads, None, None, None, None)


def _matmul_grads(x, w, g, e, block, ste):
    """(dx, dw) of the float-weight AXQ matmul: straight-through, or the
    gradient of the ``qmm_ref`` oracle (through the block scales only)."""
    if ste:
        return _ste_mm(g, w.t()).to(x.dtype), _ste_mm(x.t(), g).to(w.dtype)
    dx, dw = axq_grad.qmm_grads(x, w, g, block, e)
    return dx.to(x.dtype), dw.to(w.dtype)


class _AxqGated(torch.autograd.Function):
    """Float-weight fused gated AXQ core (see :class:`_AxqMatmul`); counted
    as ``axqmm_gated_bwd``."""

    @staticmethod
    def forward(ctx, x, wu, wg, e, block, act, plain, ste):
        ctx.save_for_backward(x, wu, wg)
        ctx.e, ctx.block, ctx.act, ctx.ste = e, block, act, ste
        return _axq.axqmm_gated(x, wu, wg, block=block, ebits=e, act=act,
                                plain=plain)

    @staticmethod
    def backward(ctx, g):
        x, wu, wg = ctx.saved_tensors
        with _build.backward_oracle("axqmm_gated_bwd", x):
            grads = _gated_grads(x, wu, wg, g, ctx.e, ctx.block, ctx.act, ctx.ste)
        return (*grads, None, None, None, None, None)


def _gated_grads(x, wu, wg, g, e, block, act, ste):
    """(dx, dw_up, dw_gate) of the float-weight fused gated core."""
    actf = _axq.ACTS[act]
    if ste:
        with torch.enable_grad():
            xx, wuu, wgg = (t.detach().requires_grad_() for t in (x, wu, wg))
            y = actf(xx @ wgg) * (xx @ wuu)
            grads = torch.autograd.grad(y, (xx, wuu, wgg), g)
    else:
        grads = axq_grad.qmm_gated_grads(x, wu, wg, g, actf, block, e)
    return [d.to(t.dtype) for d, t in zip(grads, (x, wu, wg))]


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
        if backend != "torch":
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
        if backend != "torch":
            return _axq.axqmm_gated_packed(x2, w_up, w_gate, ebits, act=act)
        return _axq.axqmm_gated_plain(x2, w_up, w_gate, ebits, act=act)
    blk = resolve_block(x2.shape[-1], block)
    return _AxqGated.apply(x2, w_up.to(torch.float32), w_gate.to(torch.float32),
                           ebits, blk, act, backend == "torch", ste)


class _AxqExperts(torch.autograd.Function):
    """Float-weight expert-batched AXQ products (``gated``: the fused first
    half): packed on the fly, one batched kernel (or plain) forward; the
    backward is each expert's 2-D one (:class:`_AxqMatmul`,
    :class:`_AxqGated`), in expert order."""

    @staticmethod
    def forward(ctx, x, wu, wg, e, block, act, plain, ste):
        ctx.save_for_backward(x, wu, wg)
        ctx.e, ctx.block, ctx.act, ctx.ste = e, block, act, ste
        pu = prepack_weight(wu, block)
        if wg is None:
            f = _axq.axqmm_experts_plain if plain else _axq.axqmm_experts_packed
            return f(x, pu, e)
        f = _axq.axqmm_gated_experts_plain if plain else _axq.axqmm_gated_experts_packed
        return f(x, pu, prepack_weight(wg, block), e, act=act)

    @staticmethod
    def backward(ctx, g):
        x, wu, wg = ctx.saved_tensors
        with _build.backward_oracle("axqmm_experts_bwd", x):
            grads = [_matmul_grads(x[i], wu[i], g[i], ctx.e, ctx.block, ctx.ste)
                     if wg is None else
                     _gated_grads(x[i], wu[i], wg[i], g[i], ctx.e, ctx.block, ctx.act,
                                  ctx.ste)
                     for i in range(x.shape[0])]
        dx, dwu, *dwg = (torch.stack(d) for d in zip(*grads))
        return dx, dwu, (dwg[0] if dwg else None), None, None, None, None, None


def axq_matmul_experts(x3: Tensor, w, *, block: int = 256, ebits=8,
                       ste: bool = False) -> Tensor:
    """Expert-batched AXQ GEMM router: x3 (E, C, K) @ each expert's weight
    -> (E, C, N) f32, one launch for the E products (recorded under the
    2-D router's site, ``gemm``: the reference vmaps that router).  ``w`` is
    a :class:`PackedQWeight` with a leading E (inference) or a float
    (E, K, N) tensor (quantized on the fly; ``ste`` picks the
    straight-through backward, as for :func:`axq_matmul`)."""
    backend = resolved_backend(x3.device)
    _record_route("gemm", backend)
    x3 = x3.to(torch.float32)
    if isinstance(w, PackedQWeight):
        if backend != "torch":
            return _axq.axqmm_experts_packed(x3, w, ebits)
        return _axq.axqmm_experts_plain(x3, w, ebits)
    blk = resolve_block(x3.shape[-1], block)
    return _AxqExperts.apply(x3, w.to(torch.float32), None, ebits, blk, "silu",
                             backend == "torch", ste)


def axq_gated_experts(x3: Tensor, w_up, w_gate, *, act: str = "silu",
                      block: int = 256, ebits=8, ste: bool = False) -> Tensor:
    """Expert-batched fused gated first half ``act(x @ w_gate) * (x @ w_up)``
    (site ``gated``); same packed-vs-float contract as
    :func:`axq_matmul_experts`."""
    backend = resolved_backend(x3.device)
    _record_route("gated", backend)
    x3 = x3.to(torch.float32)
    if isinstance(w_up, PackedQWeight):
        if backend != "torch":
            return _axq.axqmm_gated_experts_packed(x3, w_up, w_gate, ebits, act=act)
        return _axq.axqmm_gated_experts_plain(x3, w_up, w_gate, ebits, act=act)
    blk = resolve_block(x3.shape[-1], block)
    return _AxqExperts.apply(x3, w_up.to(torch.float32), w_gate.to(torch.float32), ebits,
                             blk, act, backend == "torch", ste)


# ---------------------------------------------------------------------------
# DSP routing (approximate FIR / conv2d — the Ch. 7 accelerators)
# ---------------------------------------------------------------------------


def _pr_knobs(degree, p, r):
    """Resolve the PR knobs to ``(pr, degree)``: either a ladder ``degree``
    (effective bits: a device int32 the kernels read in place, an int, or
    None for exact) or explicit raw integer (p, r) — not both."""
    if degree is not None:
        if p is not None or r is not None:
            raise ValueError("pass either degree= or explicit p=/r=, not both")
        return None, degree
    return (0 if p is None else int(p), 0 if r is None else int(r)), None


def fir(x, taps, *, tail=None, degree=None, p=None, r=None, n: int = 16,
        shift: int = 0):
    """Approximate-FIR router (DyFXU PR datapath): the kernels or their
    plain versions, selected like every other site
    (``REPRO_TORCH_KERNELS`` / :func:`set_backend`, by the tensors'
    device), recorded under ``last_route["fir"]``.

    Two call modes (int32 operands; the float/differentiable entry is
    :func:`fir_approx`):

    * offline / valid-mode (``tail=None``): ``x`` is a whole (L,) signal;
      the elementwise ``pr_multiply`` over stacked planes, host-side int64
      accumulation (arbitrary Q14 operands), returns a numpy (L - T,)
      array.  Benchmarks and examples.
    * streaming (``tail`` given): ``x`` (B, L) frame batch, ``tail``
      (B, T-1) carried history; one ``pr_fir`` launch, int32 accumulation
      (taps l1 norm <= ``2**shift``), returns ``(y, new_tail)``.  The serve
      engine.

    ``degree`` is the ladder knob (None = exact, a device int32 = runtime
    rung, read by the kernel at its address); raw (p, r) may be passed
    instead for sweep-style benches."""
    from repro_torch.kernels import dsp as _dsp

    x = torch.as_tensor(x)
    backend = resolved_backend(x.device)
    _record_route("fir", backend)
    pr, degree = _pr_knobs(degree, p, r)
    if backend == "meta":
        return (meta_ops.fir_valid(x, taps) if tail is None else
                meta_ops.pr_fir(x, taps, tail))
    plain = backend == "torch"
    if tail is None:
        if pr is None:
            pr = _dsp.degree_to_pr(degree, device=x.device)
        return _dsp.fir_valid(x, taps, pr, n=n, plain=plain)
    return _dsp.fir_frames(x, tail, taps, pr, degree=degree, n=n, shift=shift, plain=plain)


def conv2d(img, kern, *, degree=None, p=None, r=None, n: int = 16,
           shift: int = 0, pad: str = "zero"):
    """Approximate-conv2d router (same-size 2D correlation on the PR
    datapath, one ``pr_conv2d`` launch): img (B, H, W) int32, kern (kh, kw)
    int32 with l1 norm <= ``2**shift``; recorded under
    ``last_route["conv2d"]``.  Same degree/knob contract as :func:`fir`."""
    from repro_torch.kernels import dsp as _dsp

    img = torch.as_tensor(img)
    backend = resolved_backend(img.device)
    _record_route("conv2d", backend)
    pr, degree = _pr_knobs(degree, p, r)
    if backend == "meta":
        return meta_ops.pr_conv2d(img, kern)
    return _dsp.conv2d_pr(img, kern, pr, degree=degree, n=n, shift=shift, pad=pad,
                          plain=backend == "torch")


class _FirApprox(torch.autograd.Function):
    """Differentiable float FIR core: quantize -> PR streaming FIR (kernel
    or plain) -> dequantize forward; the exact-correlation straight-through
    backward (the PR bit surgery is piecewise-constant).  The integer
    knobs get no gradient."""

    @staticmethod
    def forward(ctx, x, t, pr, degree, q, n, plain):
        from repro_torch.kernels import dsp as _dsp

        scale = float(1 << q)
        lim = float((1 << (n - 1)) - 1)
        xq = torch.clamp(torch.round(x * scale), -lim, lim).to(torch.int32)
        tq = torch.clamp(torch.round(t * scale), -lim, lim).to(torch.int32)
        tail = torch.zeros((x.shape[0], t.shape[0] - 1), dtype=torch.int32,
                           device=x.device)
        y, _ = _dsp.fir_frames(xq, tail, tq, pr, degree=degree, n=n, shift=0, plain=plain)
        ctx.save_for_backward(x, t)
        return y.to(torch.float32) / (scale * scale)

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_()
            tt = t.detach().requires_grad_()
            dx, dt = torch.autograd.grad(_fir_exact(xx, tt), (xx, tt), g)
        return dx, dt, None, None, None, None, None


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
    pr, degree = _pr_knobs(degree, None, None)
    return _FirApprox.apply(x.to(torch.float32), taps.to(torch.float32), pr, degree, q,
                            n, backend == "torch")
