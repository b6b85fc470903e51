"""Flash-style attention forward with computation-skipping schedules.

Wrappers around the CUDA kernel in ``csrc/flash_attention.cu`` (port of
``repro.kernels.flash_attention``).  Three schedules (DESIGN.md §8):

  dense  every (q block, kv block) pair — non-causal layers and the
         bit-identity oracle of the skip schedules;
  tri    causal: only the n(n+1)/2 lower-triangular block pairs are visited;
  band   causal with a sliding window: each q block visits the
         ceil((window-1)/blk)+1 kv blocks its window can reach, O(S*window)
         block-steps in all.

All give bit-identical rows: a fully masked entry contributes an exact
zero, and rows that have seen only masked entries are guarded (``p`` forced
to 0 while the running max is the sentinel).  The window mask
``col > row - window`` applies on every schedule, so ``dense`` with a
window (``skip_grid=False``) is the oracle of ``band``.

:func:`flash_attention` keeps the reference's (BH, S, D) layout;
:func:`flash_attention_grouped` takes the model's (B, S, H, D) queries and
grouped (B, S, KVr, D) keys/values and indexes kv head ``h // G`` in the
kernel, so the serving path never repeats K/V to all heads.  The block
size follows the reference (:func:`planned_grid_steps`), so the kernel's
in-kernel step counter is comparable with it.

On the card, bf16 operands take the kernel's tensor-core body, whose
``cp.async`` copies need 16-byte aligned pointers and (batch, seq, head)
strides (:func:`tc_view_error`); f32 operands take its CUDA-core body.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build, meta_ops

Tensor = torch.Tensor

NEG_INF = -1e30

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims the kernel is instantiated for (``with_head_dim`` in the
#: CUDA source); any other raises on the card, with no fallback
_HEAD_DIMS = (16, 32, 64, 80, 128, 256)
_SCHEDULES = {"dense": 0, "tri": 1, "band": 2}

#: the tensor-core body's copy width in bytes (``cp.async.cg``)
TC_ALIGN = 16


def tc_view_error(t: Tensor, name: str) -> Optional[str]:
    """Why the tensor-core body cannot copy ``t`` (a (B, S, heads, D) view)
    with 16-byte ``cp.async`` pieces, or None: its pointer and every
    (batch, seq, head) stride of a dimension longer than 1 must be
    multiples of 16 bytes."""
    es, shape, stride = t.element_size(), t.shape, t.stride()
    if t.data_ptr() % TC_ALIGN:
        return f"{name}: data pointer is not {TC_ALIGN}-byte aligned"
    for dim, label in enumerate(("batch", "seq", "head")):
        if shape[dim] > 1 and (stride[dim] * es) % TC_ALIGN:
            return (f"{name}: {label} stride of {stride[dim] * es} bytes is not a "
                    f"multiple of {TC_ALIGN}")
    return None


def _block_for(S: int, bq: int, bk: int) -> int:
    """One block size for q and kv: the requested tile, shrunk to the next
    power of two >= S for short sequences."""
    b = min(bq, bk)
    if S < b:
        b = 1 << max(S - 1, 1).bit_length()
    return b


def _grid_plan(S: int, *, causal: bool, window: Optional[int],
               bq: int, bk: int, skip_grid: bool):
    """(kind, blk, n, band, window): the schedule :func:`flash_attention`
    runs (same rules as the reference)."""
    blk = _block_for(S, bq, bk)
    n = -(-S // blk)
    if window is not None and window >= S:
        window = None  # window covers the whole sequence: plain causal
    if causal and window is not None and skip_grid:
        band = min(n, -(-(window - 1) // blk) + 1)
        return "band", blk, n, band, window
    if causal and skip_grid:
        return "tri", blk, n, 0, window
    return "dense", blk, n, 0, window


def planned_grid_steps(BH: int, S: int, *, causal: bool = True,
                       window: Optional[int] = None, bq: int = 128,
                       bk: int = 128, skip_grid: bool = True) -> int:
    """Block-step count of the schedule :func:`flash_attention` runs for
    these arguments (dense count: ``skip_grid=False``)."""
    kind, _, n, band, _ = _grid_plan(S, causal=causal, window=window,
                                     bq=bq, bk=bk, skip_grid=skip_grid)
    if kind == "tri":
        return BH * n * (n + 1) // 2
    if kind == "band":
        return BH * n * band
    return BH * n * n


def _plan(S, causal, window, bq, bk, skip_grid):
    """(kind, blk, n, band, window) of :func:`_grid_plan`; a window without
    the causal mask raises, as in the reference."""
    if window is not None and not causal:
        raise NotImplementedError("sliding-window attention requires causal=True")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 token, got {window}")
    return _grid_plan(S, causal=causal, window=window, bq=bq, bk=bk,
                      skip_grid=skip_grid)


def _kv_blocks(kind: str, i: int, n: int, band: int) -> range:
    """The kv blocks q block ``i`` visits on schedule ``kind``."""
    if kind == "tri":
        return range(i + 1)
    if kind == "band":
        j0 = max(i - (band - 1), 0)
        return range(j0, j0 + band)
    return range(n)


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          bq: int = 128, bk: int = 128,
                          skip_grid: bool = True) -> tuple[Tensor, int]:
    """Plain version: the same block schedule and online softmax, blockwise
    in PyTorch.  q, k, v (BH, S, D) -> ((BH, S, D) in q.dtype, steps).

    The scores, the softmax and the sums run in float64 on the f32 operands
    (the scaled q rounded to f32 as in the kernel), and each output row is
    rounded to f32 once: a row's result then depends neither on the tile
    width nor on the order the BLAS sums in, so a prompt padded to a longer
    bucket gives the same bits as at its exact length (masked entries
    contribute exact zeros)."""
    if q.is_cuda:
        _build.plain_cuda_calls["flash_attention"] += 1
    BH, S, D = q.shape
    kind, blk, n, band, window = _plan(S, causal, window, bq, bk, skip_grid)
    f64 = torch.float64
    qf = (q.to(torch.float32) * (1.0 / math.sqrt(D))).to(f64)
    kf, vf = k.to(f64), v.to(f64)
    out = torch.empty((BH, S, D), dtype=torch.float32, device=q.device)
    steps = 0
    for i in range(n):
        r0, r1 = i * blk, min((i + 1) * blk, S)
        qi = qf[:, r0:r1]
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        m = torch.full((BH, r1 - r0, 1), NEG_INF, dtype=f64, device=q.device)
        l = torch.zeros((BH, r1 - r0, 1), dtype=f64, device=q.device)
        acc = torch.zeros((BH, r1 - r0, D), dtype=f64, device=q.device)
        for j in _kv_blocks(kind, i, n, band):
            steps += BH
            c0, c1 = j * blk, min((j + 1) * blk, S)
            s = qi @ kf[:, c0:c1].transpose(1, 2)
            cols = torch.arange(c0, c1, device=q.device)[None, :]
            if causal:
                s = torch.where(cols <= rows, s, NEG_INF)
            if window is not None:
                s = torch.where(cols > rows - window, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(s > 0.5 * NEG_INF, torch.exp(s - m_new), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            m = m_new
            acc = acc * corr + p @ vf[:, c0:c1]
        out[:, r0:r1] = (acc / torch.clamp(l, min=1e-30)).to(torch.float32)
    return out.to(q.dtype), steps


def _launch(q4: Tensor, k4: Tensor, v4: Tensor, out4: Tensor, *, G: int,
            plan, causal: bool, count_steps: bool):
    """Launch on (B, S, H, D)-strided views (D contiguous) with ``plan`` =
    (kind, blk, n, band, window) from :func:`_plan`."""
    kind, blk, _, band, window = plan
    _build.require_sm90(q4)
    B, S, H, D = q4.shape
    dev = q4.device
    if q4.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes f32 or bf16, got {q4.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash_attention kernel head_dim must be one of "
                         f"{_HEAD_DIMS}, got {D}")
    for t, name in ((q4, "q"), (k4, "k"), (v4, "v"), (out4, "out")):
        if t.device != dev or t.dtype != q4.dtype:
            raise ValueError(f"{name}: expected {q4.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: head_dim must be contiguous")
    if k4.shape != (B, S, H // G, D) or v4.stride() != k4.stride():
        raise ValueError(f"k/v must be (B, S, H/G, D) views with equal strides, "
                         f"got {tuple(k4.shape)}")
    if q4.dtype == torch.bfloat16:
        for t, name in ((q4, "q"), (k4, "k"), (v4, "v"), (out4, "out")):
            why = tc_view_error(t, name)
            if why is not None:
                raise ValueError(f"flash_attention (bf16 tensor-core body): {why}")
    steps = torch.zeros((), dtype=torch.int32, device=dev) if count_steps else None
    rc = _build.entry("flash_attention_launch")(
        q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), out4.data_ptr(),
        None if steps is None else steps.data_ptr(),
        B, S, H, G, D, blk, int(causal), _SCHEDULES[kind], band, window or 0,
        q4.stride(0), q4.stride(1), q4.stride(2),
        k4.stride(0), k4.stride(1), k4.stride(2),
        out4.stride(0), out4.stride(1), out4.stride(2),
        _DTYPES[q4.dtype], 1.0 / math.sqrt(D), _build.stream_of(q4))
    _build.check(rc, "flash_attention")
    _build.launches["flash_attention"] += 1
    _build.flash_schedules[kind] += 1
    return steps


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None, bq: int = 128, bk: int = 128,
                    skip_grid: bool = True, return_steps: bool = False):
    """q, k, v: (BH, S, D) -> (BH, S, D) in q.dtype.  ``return_steps`` ->
    (out, block-steps executed): an int32 device scalar counted in the
    kernel on the card, a Python int from the plain version on the CPU."""
    if q.device.type == "cpu":
        out, steps = flash_attention_plain(q, k, v, causal=causal, window=window,
                                           bq=bq, bk=bk, skip_grid=skip_grid)
        return (out, steps) if return_steps else out
    plan = _plan(q.shape[1], causal, window, bq, bk, skip_grid)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    steps = _launch(q[:, :, None], k[:, :, None], v[:, :, None], out[:, :, None],
                    G=1, plan=plan, causal=causal, count_steps=return_steps)
    return (out, steps) if return_steps else out


def _flat(x: Tensor) -> Tensor:
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D)


def flash_attention_grouped_plain(q: Tensor, k: Tensor, v: Tensor, *,
                                  causal: bool = True,
                                  window: Optional[int] = None) -> Tensor:
    """Plain version of :func:`flash_attention_grouped` (repeats K/V to all
    heads and runs the (BH, S, D) plain version)."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    kf = k.repeat_interleave(G, dim=2)
    vf = v.repeat_interleave(G, dim=2)
    o, _ = flash_attention_plain(_flat(q), _flat(kf), _flat(vf), causal=causal,
                                 window=window)
    return o.reshape(B, H, S, D).transpose(1, 2)


def flash_attention_grouped(q: Tensor, k: Tensor, v: Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None) -> Tensor:
    """Model-layout entry: q (B, S, H, D), k/v (B, S, KVr, D) -> (B, S, H, D).
    The kernel indexes kv head ``h // (H // KVr)``; no K/V repeat."""
    B, S, H, D = q.shape
    KVr = k.shape[2]
    if H % KVr:
        raise ValueError(f"{H} query heads do not group over {KVr} kv heads")
    if q.device.type == "cpu":
        return flash_attention_grouped_plain(q, k, v, causal=causal, window=window)
    plan = _plan(S, causal, window, 128, 128, True)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, G=H // KVr, plan=plan, causal=causal, count_steps=False)
    return out


# ---------------------------------------------------------------------------
# differentiable wrapper — the forward through the kernel, the backward
# through the materialized oracle (the reference's flash_attention_vjp)
# ---------------------------------------------------------------------------


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                        window: Optional[int] = None) -> Tensor:
    """Materialized oracle in the model layout, the math of the reference's
    ``flash_attention_ref``: f32 scores over all (S, S) pairs, the mask,
    softmax, an f32 P V product, the output cast to q's dtype.  q (B, S, H,
    D), k/v (B, S, KVr, D) grouped: query head h reads kv head h // (H //
    KVr), so autograd sums dK and dV over each group's heads (the
    reference repeats K/V to all heads first; its repeat's transpose sums
    the same terms)."""
    B, S, H, D = q.shape
    KVr = k.shape[2]
    qg = q.reshape(B, S, KVr, H // KVr, D).to(torch.float32)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) / math.sqrt(D)
    ii = torch.arange(S, device=q.device)[:, None]
    jj = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= jj <= ii
    if window is not None:
        mask &= jj > ii - window
    p = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.to(torch.float32))
    return o.reshape(B, S, H, D).to(q.dtype)


class _FlashAttentionVJP(torch.autograd.Function):
    """Forward: :func:`flash_attention_grouped` (the kernel on the card; with
    ``plain``, or on the CPU, its plain version; on meta tensors the
    kernel's op, ``kernels/meta_ops.py``).  Backward: autograd
    through :func:`flash_attention_ref` on the saved q, k, v, counted as
    ``flash_attention_bwd`` (``_build.backward_calls``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, plain):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.device.type == "meta":
            return meta_ops.flash_attention(q, k, v, window)
        if plain:
            return flash_attention_grouped_plain(q, k, v, causal=causal, window=window)
        return flash_attention_grouped(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with _build.backward_oracle("flash_attention_bwd", q), torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            o = flash_attention_ref(qq, kk, vv, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(o, (qq, kk, vv), g)
        return dq, dk, dv, None, None, None


def flash_attention_vjp(q: Tensor, k: Tensor, v: Tensor, causal: bool = True,
                        window: Optional[int] = None, plain: bool = False) -> Tensor:
    """Differentiable grouped prefill attention, model layout: q (B, S, H,
    D), k/v (B, S, KVr, D) -> (B, S, H, D).  The forward is the kernel (or,
    with ``plain`` or on the CPU, its plain version; on meta tensors its
    op, ``kernels/meta_ops.py``); the gradients come
    from the materialized oracle, as the reference's custom VJP takes them
    (O(S^2) memory in the backward)."""
    return _FlashAttentionVJP.apply(q, k, v, causal, window, plain)
