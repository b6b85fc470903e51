"""Approximate DSP compute cores on the PR multiplier (Ch. 7 accelerators;
the port of ``repro.kernels.dsp``).

The dissertation's DSP accelerators — 1D FIR filtering and 2D convolution —
are product-sum pipelines over the Ch. 5 PR (perforation + rounding)
multiplier.  This module holds the *compute cores* behind the
``kernels.dispatch.fir`` / ``dispatch.conv2d`` routers: operand conversion
and the choice of kernel (``kernels.axmult_elem``).

* :func:`fir_frames` (the serving stage) takes ``pr_fir`` and
  :func:`conv2d_pr` takes ``pr_conv2d``: one launch a stage, which reads
  the signal and its halo once and never materialises the reference's
  operand planes (their plain versions are that materialised route).
* :func:`fir_valid` (the offline Tables 7.1/7.2 bench layout) keeps the
  reference's stacked (T, L) planes through the elementwise
  ``pr_multiply``: it sums on the host in int64, which an int32 sum on the
  device would wrap.

Operand convention (weight-stationary accelerator): the *weights* (FIR taps,
conv kernel) are the rounded operand A, the *samples* (signal, pixels) the
perforated operand B — matching ``_pr_kernel``'s (a, b) roles.

Fixed-point safety: accumulation stays in wrapping int32 (the reference's
``jnp.sum`` of int32 wraps, where a plain ``torch.sum`` would widen to
int64), so streaming entry points require the weight vector's l1 norm to
fit ``2**shift`` — quantizing weights with :func:`quantize_weights`
guarantees ``|sum_i w_i * x_i| <= 2**shift * max|x|`` and the post-sum
``>> shift`` (arithmetic) returns the result to the input's Q format.

Knobs: every core takes ``pr`` — a device ``int32[2]`` or two ints — and
the streaming cores take a ``degree`` instead (a device int32 read in place
by the kernel, an int, or None for exact; :func:`degree_to_pr` is the
mapping).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.axmult_elem import degree_to_pr  # noqa: F401
from repro_torch.kernels.axmult_elem import (pr_conv2d, pr_conv2d_plain, pr_fir,
                                             pr_fir_plain, pr_multiply, pr_multiply_plain)

Tensor = torch.Tensor

I32 = torch.int32


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


def fir_frames(frames: Tensor, tail: Tensor, taps: Tensor, pr=None, *, degree=None,
               n: int = 16, shift: int = 0, plain: bool = False):
    """Streaming FIR over one frame batch (the serve-engine step).

    frames (B, L) int32 samples, tail (B, T-1) the previous frame's carried
    history (zeros at stream start), taps (T,) int32 with l1 norm <=
    ``2**shift``; ``pr`` or ``degree`` the knobs.  Returns ``(y (B, L)
    int32 >> shift, new_tail (B, T-1))`` — outputs are continuous across
    frames: frame-by-frame equals one whole-signal pass.  One ``pr_fir``
    launch (or, with ``plain``, its plain version)."""
    frames = torch.as_tensor(frames).to(I32).contiguous()
    dev = frames.device
    tail = torch.as_tensor(tail).to(device=dev, dtype=I32).contiguous()
    taps = torch.as_tensor(taps).to(device=dev, dtype=I32).contiguous()
    fn = pr_fir_plain if plain else pr_fir
    return fn(frames, tail, taps, pr, degree=degree, n=n, shift=shift)


def conv2d_pr(img: Tensor, kern: Tensor, pr=None, *, degree=None, n: int = 16,
              shift: int = 0, pad: str = "zero", plain: bool = False) -> Tensor:
    """Same-size 2D correlation through the PR datapath.

    img (B, H, W) int32 pixels, kern (kh, kw) int32 weights with l1 norm <=
    ``2**shift``; ``pr`` or ``degree`` the knobs.  ``pad``: "edge"
    replicates the border, anything else pads with zeros.  Returns (B, H, W)
    int32 ``>> shift``.  One ``pr_conv2d`` launch (or, with ``plain``, its
    plain version)."""
    img = torch.as_tensor(img).to(I32).contiguous()
    kern = torch.as_tensor(kern).to(device=img.device, dtype=I32).contiguous()
    fn = pr_conv2d_plain if plain else pr_conv2d
    return fn(img, kern, pr, degree=degree, n=n, shift=shift, pad=pad)
