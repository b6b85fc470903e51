"""Approximate DSP compute cores on the PR multiplier (Ch. 7 accelerators;
the port of ``repro.kernels.dsp``).

The dissertation's DSP accelerators — 1D FIR filtering and 2D convolution —
are product-sum pipelines over the Ch. 5 PR (perforation + rounding)
multiplier.  This module holds the *compute cores* behind the
``kernels.dispatch.fir`` / ``dispatch.conv2d`` routers: the batched operand
layout (all taps / all kernel offsets stacked into ONE elementwise PR call
of ``kernels.axmult_elem.pr_multiply``) and the integer accumulation.

Operand convention (weight-stationary accelerator): the *weights* (FIR taps,
conv kernel) are the rounded operand A, the *samples* (signal, pixels) the
perforated operand B — matching ``_pr_kernel``'s (a, b) roles.

The kernel takes flat contiguous int32, so :func:`pr_product` makes its
operands contiguous: the broadcast taps and the window planes are
materialised on the device before the launch, as in the reference.  The
CUDA kernel handles a ragged size itself, so there is no padding to a block
multiple (the reference's ``PR_BLOCK`` is a Pallas constraint).

Fixed-point safety: accumulation stays in wrapping int32 (``dtype=
torch.int32``; the reference's ``jnp.sum`` of int32 wraps, where a plain
``torch.sum`` would widen to int64), so streaming entry points require the
weight vector's l1 norm to fit ``2**shift`` — quantizing weights with
:func:`quantize_weights` guarantees ``|sum_i w_i * x_i| <= 2**shift *
max|x|`` and the post-sum ``>> shift`` (arithmetic) returns the result to
the input's Q format.  The offline :func:`fir_valid` (benchmarks, arbitrary
Q14 operands) accumulates on the host in int64 instead.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.axmult_elem import pr_multiply, pr_multiply_plain

Tensor = torch.Tensor

I32 = torch.int32


def degree_to_pr(degree, *, device=None) -> Tensor:
    """Map an effective-bits degree (8 = exact, down the QoS ladder) to the
    DyFXU (p, r) configuration registers: each lost bit costs two rounding
    bits and every second lost bit one perforation step —
    ``e=8 -> (0,0), 7 -> (0,2), 6 -> (1,4), 5 -> (1,6), 4 -> (2,8)``.

    ``degree`` is None (exact: a cached device constant (0, 0)), an int, or
    an int32 tensor on the device (the engine's site degree: computed with
    device ops, never read on the host).  Returns the (p, r) pair as a
    device ``int32[2]``."""
    if degree is None:
        return _build._const_i32((0, 0), str(torch.device(device or "cpu")))
    deg = torch.as_tensor(degree, dtype=I32, device=device)
    d = torch.clamp(8 - deg, min=0)
    return torch.stack([d // 2, 2 * d]).to(I32)


def quantize_weights(w, shift: int):
    """Quantize a float weight vector/kernel so its l1 norm is <= 2**shift
    (int32-safe accumulation for Q-``shift`` samples): returns int32 weights
    whose product-sum dequantizes via ``>> shift``.  Host-side numpy, as in
    the reference."""
    w = np.asarray(w, np.float64)
    scale = float(1 << shift) / max(float(np.abs(w).sum()), 1e-30)
    return np.round(w * scale).astype(np.int32)


#: the plain route's PR product (the reference's ``xla``-route twin)
pr_multiply_ref = pr_multiply_plain


def pr_product(a: Tensor, b: Tensor, pr, *, n: int = 16,
               plain: bool = False) -> Tensor:
    """One elementwise PR product through the kernel (or, with ``plain``,
    its plain version).  Operands are made contiguous int32 first."""
    a = torch.as_tensor(a).to(I32).contiguous()
    b = torch.as_tensor(b).to(I32).contiguous()
    if plain:
        return pr_multiply_plain(a, b, pr, n=n)
    return pr_multiply(a, b, pr, n=n)


def fir_valid(sig, taps, pr, *, n: int = 16, plain: bool = False) -> np.ndarray:
    """Valid-mode batched FIR (the Ch. 7 Tables 7.1/7.2 bench layout):
    ``y[j] = sum_i taps[i] * sig[i + j]`` for ``j < len(sig) - len(taps)``.

    All taps ride ONE PR call as stacked (T, L) operand planes on the
    signal's device; accumulation is host-side int64 (unbounded Q14
    operands overflow int32 lanes).  Returns a numpy int64 (L,) array."""
    sig = torch.as_tensor(sig).to(I32)
    taps = torch.as_tensor(taps).to(device=sig.device, dtype=I32)
    T = taps.shape[0]
    L = sig.shape[0] - T
    a = taps[:, None].expand(T, L)
    b = sig.unfold(0, L, 1)[:T]                  # (T, L) overlapping windows
    prod = pr_product(a, b, pr, n=n, plain=plain)
    return prod.cpu().numpy().astype(np.int64).sum(axis=0)


def fir_frames(frames: Tensor, tail: Tensor, taps: Tensor, pr, *, n: int = 16,
               shift: int = 0, plain: bool = False):
    """Streaming FIR over one frame batch (the serve-engine step).

    frames (B, L) int32 samples, tail (B, T-1) the previous frame's carried
    history (zeros at stream start), taps (T,) int32 with l1 norm <=
    ``2**shift``.  Returns ``(y (B, L) int32 >> shift, new_tail (B, T-1))``
    — outputs are continuous across frames: frame-by-frame equals one
    whole-signal pass."""
    frames = torch.as_tensor(frames).to(I32)
    B, L = frames.shape
    taps = torch.as_tensor(taps).to(device=frames.device, dtype=I32)
    T = taps.shape[0]
    ext = torch.cat([torch.as_tensor(tail).to(device=frames.device, dtype=I32),
                     frames], dim=1)
    win = torch.stack([ext[:, i:i + L] for i in range(T)])      # (T, B, L)
    a = taps[:, None, None].expand(win.shape)
    prod = pr_product(a, win, pr, n=n, plain=plain)
    acc = torch.sum(prod, dim=0, dtype=I32)
    y = acc >> shift if shift else acc
    return y, ext[:, L:]


def _edge_index(size: int, before: int, after: int, device) -> Tensor:
    """Clamped source indices of an edge-padded axis (works for any dtype
    on any device, unlike replicate padding of int32)."""
    return torch.clamp(torch.arange(-before, size + after, device=device), 0, size - 1)


def conv2d_pr(img: Tensor, kern: Tensor, pr, *, n: int = 16, shift: int = 0,
              pad: str = "zero", plain: bool = False) -> Tensor:
    """Same-size 2D correlation through the PR datapath.

    img (B, H, W) int32 pixels, kern (kh, kw) int32 weights with l1 norm <=
    ``2**shift``; all kh*kw offsets ride ONE PR call as stacked patch
    planes.  ``pad``: "edge" replicates the border, anything else pads with
    zeros.  Returns (B, H, W) int32 ``>> shift``."""
    img = torch.as_tensor(img).to(I32)
    kern = torch.as_tensor(kern).to(device=img.device, dtype=I32)
    B, H, W = img.shape
    kh, kw = kern.shape
    ph, pw = kh // 2, kw // 2
    if kh == 1 and kw == 1:
        ext = img
    elif pad == "edge":
        rows = _edge_index(H, ph, kh - 1 - ph, img.device)
        cols = _edge_index(W, pw, kw - 1 - pw, img.device)
        ext = img[:, rows][:, :, cols]
    else:
        ext = F.pad(img, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    patches = torch.stack([ext[:, dy:dy + H, dx:dx + W]
                           for dy in range(kh) for dx in range(kw)])
    a = kern.reshape(-1)[:, None, None, None].expand(patches.shape)
    prod = pr_product(a, patches, pr, n=n, plain=plain)
    acc = torch.sum(prod, dim=0, dtype=I32)
    return acc >> shift if shift else acc
