"""axmult_elem — the dissertation's PR (perforation + rounding) multiplier as
hand-written CUDA kernels (``csrc/axmult_elem.cu``; port of
``repro.kernels.axmult_elem`` and of the product-sums
``repro.kernels.dsp`` builds around it).

For int32 operands A, B holding n-bit values, the DyFXU product is
``round_r(A) * perforate_p(B)`` with the hardware's shift/mask/add bit
surgery (the Ch. 5 circuit).  Three kernels compute it:

* :func:`pr_multiply` — elementwise over two tensors of one shape (the
  reference's ``_pr_kernel``; the offline FIR bench layout takes it);
* :func:`pr_fir` — the streaming FIR stage, ``y = (sum_i round_r(taps_i) *
  perforate_p(ext[:, i + j])) >> shift`` over ``ext = cat(tail, frames)``,
  and the carried tail, in one launch;
* :func:`pr_conv2d` — same-size 2D correlation with zero or edge padding
  in one launch.

The configuration registers (p, r) are read by the kernels by address: a
QoS rung move writes new values on the device and rebuilds, re-specialises
and syncs nothing.  Every kernel takes them as ``pr``: a device
``int32[2]`` (what :func:`degree_to_pr` returns) or a pair of Python ints
(raw sweep knobs, a cached device constant).  :func:`pr_fir` and
:func:`pr_conv2d` take, instead of ``pr``, the site's ``degree`` itself —
a device int32 (one element of the engine's degree vector, read in place),
an int, or None (exact) — and map it on the device as
:func:`degree_to_pr` does.

Each wrapper launches its kernel for a CUDA tensor (or raises: no fallback)
and uses its plain version only for a CPU tensor.  The plain versions are
the reference's bit math in plain PyTorch int32 ops (``>>`` on int32 is an
arithmetic shift and ``<<`` wraps, as in XLA): elementwise, and for the
product-sums the reference's materialised layout — T (kh*kw) shifted
planes, broadcast weights, one elementwise product, a wrapping int32 sum.
The kernels factor that sum (each sample perforated once, each weight
rounded once); products and sum wrap modulo 2^32, so the two agree bit for
bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

Tensor = torch.Tensor

I32 = torch.int32

#: the product-sum kernels' limits (``csrc/axmult_elem.cu`` sizes its
#: shared-memory arrays by the same numbers): FIR taps, conv kernel rows
#: and columns, and the batch rows that ride one grid dimension
FIR_MAX_TAPS = 256
CONV_MAX_K = 16
MAX_BATCH = 65535


def _check_n(n: int) -> None:
    if not 1 <= n <= 31:
        raise ValueError(f"operand width n must be in [1, 31], got {n}")


def _check_shift(shift: int) -> None:
    if not 0 <= shift <= 31:
        raise ValueError(f"shift must be in [0, 31], got {shift}")


def degree_to_pr(degree, *, device=None) -> Tensor:
    """Map an effective-bits degree (8 = exact, down the QoS ladder) to the
    DyFXU (p, r) configuration registers: each lost bit costs two rounding
    bits and every second lost bit one perforation step —
    ``e=8 -> (0,0), 7 -> (0,2), 6 -> (1,4), 5 -> (1,6), 4 -> (2,8)``.

    ``degree`` is None (exact: a cached device constant (0, 0)), an int, or
    an int32 tensor on the device (the engine's site degree: computed with
    device ops, never read on the host).  Returns the (p, r) pair as a
    device ``int32[2]``.  The product-sum kernels do the same mapping
    themselves from the degree's address."""
    if degree is None:
        return _build._const_i32((0, 0), str(torch.device(device or "cpu")))
    deg = torch.as_tensor(degree, dtype=I32, device=device)
    d = torch.clamp(8 - deg, min=0)
    return torch.stack([d // 2, 2 * d]).to(I32)


def _pr_bits(a: Tensor, b: Tensor, pr, n: int) -> Tensor:
    """``round_r(a) * perforate_p(b)`` in plain PyTorch int32 ops, step for
    step as ``_pr_kernel``."""
    pr = _build.pr_operand(pr, a.device)
    p, r = pr[0], pr[1]
    a = a.to(I32)
    b = b.to(I32)
    # rounding: A_r = (floor(A / 2^r) + a_{r-1}) * 2^r  (r = 0 -> identity)
    rbit = torch.where(r > 0, (a >> torch.clamp(r - 1, min=0)) & 1, 0)
    a_r = torch.where(r > 0, ((a >> r) + rbit) << r, a)
    # perforation: B' = B - (B mod 2^{2p}) + 2^{2p} * b_{2p-1}
    u = b & ((1 << n) - 1)
    two_p = torch.ones((), dtype=I32, device=a.device) << (2 * p)
    low = u & (two_p - 1)
    cbit = (u >> torch.clamp(2 * p - 1, min=0)) & 1
    b_p = torch.where(p > 0, b - low + cbit * two_p, b)
    return a_r * b_p


def pr_multiply_plain(a: Tensor, b: Tensor, pr, *, n: int = 16) -> Tensor:
    """Plain version of :func:`pr_multiply`: the kernel's bit math in plain
    PyTorch int32 ops, step for step as ``_pr_kernel``."""
    _check_n(n)
    if a.is_cuda:
        _build.plain_cuda_calls["pr_multiply"] += 1
    return _pr_bits(a, b, pr, n)


def pr_multiply(a: Tensor, b: Tensor, pr, *, n: int = 16) -> Tensor:
    """Elementwise DyFXU product of int32 operand tensors (n-bit values).

    a, b: int32, same shape, contiguous, on one device; ``pr`` the (p, r)
    pair (device ``int32[2]`` or two ints).  Returns int32 of a's shape.
    Any shape and size (a ragged tail is handled in the kernel); CPU
    tensors take the plain version."""
    if a.device.type == "cpu":
        return pr_multiply_plain(a, b, pr, n=n)
    _check_n(n)
    _build.require_sm90(a)
    dev = a.device
    _build.expect(a, "a", I32, dev)
    _build.expect(b, "b", I32, dev, a.shape)
    prt = _build.pr_operand(pr, dev)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    rc = _build.entry("pr_multiply_launch")(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), prt.data_ptr(), a.numel(), n,
        _build.stream_of(a))
    _build.check(rc, "pr_multiply")
    _build.launches["pr_multiply"] += 1
    return out


# ---------------------------------------------------------------------------
# the product-sums: streaming FIR and same-size 2D correlation
# ---------------------------------------------------------------------------


def _knob_pair(pr, degree):
    if pr is not None and degree is not None:
        raise ValueError("pass either pr or degree, not both")


def _plain_pr(pr, degree, device):
    """The (p, r) the plain versions apply: ``pr`` as given, else the
    degree's (exact for None)."""
    _knob_pair(pr, degree)
    return pr if pr is not None else degree_to_pr(degree, device=device)


def _knob_operand(pr, degree, device):
    """(device int32 the kernel reads, is_degree): ``pr`` through
    :func:`_build.pr_operand`, a degree through :func:`_build.degree_ptr`
    (a tensor used in place), None as the exact pair (0, 0)."""
    _knob_pair(pr, degree)
    if pr is not None:
        return _build.pr_operand(pr, device), 0
    if degree is None:
        return _build.pr_operand((0, 0), device), 0
    return _build.degree_ptr(degree, device), 1


def planes_sum(a: Tensor, planes: Tensor, pr, *, n: int = 16, shift: int = 0) -> Tensor:
    """The reference's product-sum over stacked operand planes: one
    elementwise PR product of the broadcast weights ``a`` and ``planes``,
    a wrapping int32 sum over the first axis, ``>> shift``."""
    prod = _pr_bits(a.expand(planes.shape), planes, pr, n)
    acc = torch.sum(prod, dim=0, dtype=I32)       # wraps, as jnp.sum of int32
    return acc >> shift if shift else acc


def fir_planes(frames: Tensor, tail: Tensor, taps: Tensor):
    """The reference's FIR operand layout: ``ext = cat(tail, frames)``, its
    T shifted (B, L) windows stacked into (T, B, L) planes, and the taps
    shaped to broadcast against them.  Returns ``(taps (T, 1, 1), planes,
    ext)``."""
    L = frames.shape[1]
    ext = torch.cat([tail, frames], dim=1)
    win = torch.stack([ext[:, i:i + L] for i in range(taps.shape[0])])
    return taps[:, None, None], win, ext


def pr_fir_plain(frames: Tensor, tail: Tensor, taps: Tensor, pr=None, *, degree=None,
                 n: int = 16, shift: int = 0):
    """Plain version of :func:`pr_fir`: the reference's materialised route
    (:func:`fir_planes`, then :func:`planes_sum`).  Returns ``(y,
    ext[:, L:])``."""
    _check_n(n)
    _check_shift(shift)
    if frames.is_cuda:
        _build.plain_cuda_calls["pr_fir"] += 1
    pr = _plain_pr(pr, degree, frames.device)
    a, win, ext = fir_planes(frames, tail, taps)
    return planes_sum(a, win, pr, n=n, shift=shift), ext[:, frames.shape[1]:]


def pr_fir(frames: Tensor, tail: Tensor, taps: Tensor, pr=None, *, degree=None,
           n: int = 16, shift: int = 0):
    """Streaming FIR stage in one launch: frames (B, L), tail (B, T-1) the
    carried history, taps (T,), all int32, contiguous, on one device.

    Returns ``(y (B, L), new_tail (B, T-1))``: ``y[b, j] = (sum_i
    round_r(taps[i]) * perforate_p(ext[b, i + j])) >> shift`` (wrapping
    int32 sum, arithmetic shift) and ``new_tail = ext[:, L:]`` as raw
    samples, in a buffer of its own, with ``ext = cat(tail, frames)``.
    Knobs: ``pr`` or ``degree`` (module docstring).  CPU tensors take the
    plain version; 1 <= T <= ``FIR_MAX_TAPS`` and B <= ``MAX_BATCH`` on the
    card, else it raises."""
    if frames.device.type == "cpu":
        return pr_fir_plain(frames, tail, taps, pr, degree=degree, n=n, shift=shift)
    _check_n(n)
    _check_shift(shift)
    _build.require_sm90(frames)
    dev = frames.device
    if frames.dim() != 2 or taps.dim() != 1:
        raise ValueError(f"pr_fir takes frames (B, L) and taps (T,), got "
                         f"{tuple(frames.shape)} and {tuple(taps.shape)}")
    B, L = frames.shape
    T = taps.shape[0]
    if not 1 <= T <= FIR_MAX_TAPS:
        raise ValueError(f"pr_fir takes 1..{FIR_MAX_TAPS} taps (its shared-memory "
                         f"halo), got {T}")
    if B > MAX_BATCH:
        raise ValueError(f"pr_fir takes at most {MAX_BATCH} rows, got {B}")
    _build.expect(frames, "frames", I32, dev)
    _build.expect(tail, "tail", I32, dev, (B, T - 1))
    _build.expect(taps, "taps", I32, dev)
    knob, is_degree = _knob_operand(pr, degree, dev)
    y = torch.empty_like(frames)
    if frames.numel() == 0:        # nothing to launch: the tail is the old one
        return y, tail.clone()
    new_tail = torch.empty_like(tail)
    rc = _build.entry("pr_fir_launch")(
        frames.data_ptr(), tail.data_ptr(), taps.data_ptr(), y.data_ptr(),
        new_tail.data_ptr(), knob.data_ptr(), is_degree, B, L, T, n, shift,
        _build.stream_of(frames))
    _build.check(rc, "pr_fir")
    _build.launches["pr_fir"] += 1
    return y, new_tail


def _edge_index(size: int, before: int, after: int, device) -> Tensor:
    """Clamped source indices of an edge-padded axis (works for any dtype
    on any device, unlike replicate padding of int32)."""
    return torch.clamp(torch.arange(-before, size + after, device=device), 0, size - 1)


def conv_planes(img: Tensor, kern: Tensor, pad: str = "zero"):
    """The reference's conv operand layout: the image padded by ``kh // 2``
    rows (``kw // 2`` columns) before and the rest after — replicated for
    "edge", zeros otherwise — its kh*kw shifted (B, H, W) patches stacked
    into planes, and the weights shaped to broadcast against them.  Returns
    ``(kern (kh*kw, 1, 1, 1), planes)``."""
    _, H, W = img.shape
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
    return kern.reshape(-1)[:, None, None, None], patches


def pr_conv2d_plain(img: Tensor, kern: Tensor, pr=None, *, degree=None, n: int = 16,
                    shift: int = 0, pad: str = "zero") -> Tensor:
    """Plain version of :func:`pr_conv2d`: the reference's materialised
    route (:func:`conv_planes`, then :func:`planes_sum`)."""
    _check_n(n)
    _check_shift(shift)
    if img.is_cuda:
        _build.plain_cuda_calls["pr_conv2d"] += 1
    pr = _plain_pr(pr, degree, img.device)
    a, patches = conv_planes(img, kern, pad)
    return planes_sum(a, patches, pr, n=n, shift=shift)


def pr_conv2d(img: Tensor, kern: Tensor, pr=None, *, degree=None, n: int = 16,
              shift: int = 0, pad: str = "zero") -> Tensor:
    """Same-size 2D correlation in one launch: img (B, H, W), kern (kh, kw),
    int32, contiguous, on one device; ``pad`` "edge" replicates the border,
    anything else pads with zeros (``kh // 2`` rows before, the rest after,
    as the reference pads an even kernel).  Returns (B, H, W) int32
    ``(sum round_r(w) * perforate_p(x)) >> shift``.  Knobs: ``pr`` or
    ``degree``.  CPU tensors take the plain version; kh, kw <=
    ``CONV_MAX_K`` and B <= ``MAX_BATCH`` on the card, else it raises."""
    if img.device.type == "cpu":
        return pr_conv2d_plain(img, kern, pr, degree=degree, n=n, shift=shift, pad=pad)
    _check_n(n)
    _check_shift(shift)
    _build.require_sm90(img)
    dev = img.device
    if img.dim() != 3 or kern.dim() != 2:
        raise ValueError(f"pr_conv2d takes img (B, H, W) and kern (kh, kw), got "
                         f"{tuple(img.shape)} and {tuple(kern.shape)}")
    B, H, W = img.shape
    kh, kw = kern.shape
    if not (1 <= kh <= CONV_MAX_K and 1 <= kw <= CONV_MAX_K):
        raise ValueError(f"pr_conv2d takes kernels of 1..{CONV_MAX_K} rows and columns "
                         f"(its shared-memory halo), got {kh}x{kw}")
    if B > MAX_BATCH:
        raise ValueError(f"pr_conv2d takes at most {MAX_BATCH} images, got {B}")
    _build.expect(img, "img", I32, dev)
    _build.expect(kern, "kern", I32, dev)
    knob, is_degree = _knob_operand(pr, degree, dev)
    out = torch.empty_like(img)
    if img.numel() == 0:
        return out
    rc = _build.entry("pr_conv2d_launch")(
        img.data_ptr(), kern.data_ptr(), out.data_ptr(), knob.data_ptr(), is_degree,
        B, H, W, kh, kw, int(pad == "edge"), n, shift, _build.stream_of(img))
    _build.check(rc, "pr_conv2d")
    _build.launches["pr_conv2d"] += 1
    return out
