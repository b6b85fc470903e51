"""axmult_elem — the dissertation's PR (perforation + rounding) multiplier,
elementwise, as a hand-written CUDA kernel (``csrc/axmult_elem.cu``; port of
``repro.kernels.axmult_elem``).

For int32 operand tensors A, B holding n-bit values, compute
``round_r(A) * perforate_p(B)`` with the hardware's shift/mask/add bit
surgery (the Ch. 5 DyFXU).  The configuration registers (p, r) are one
device ``int32[2]`` that the kernel reads by address: a QoS rung move writes
new values on the device and rebuilds, re-specialises and syncs nothing.
Where the JAX kernel takes ``p, r`` as two scalar-prefetch operands, the
port takes the pair as one operand ``pr``: a device ``int32[2]`` (what
``dsp.degree_to_pr`` returns) or a pair of Python ints (raw sweep knobs, a
cached device constant).

:func:`pr_multiply` launches the kernel for a CUDA tensor (or raises) and
uses :func:`pr_multiply_plain` only for a CPU tensor.  The plain version is
the same bit math in plain PyTorch int32 ops (``>>`` on int32 is an
arithmetic shift and ``<<`` wraps, as in XLA), bit-identical to the Pallas
kernel and to ``core.axmult.pr_multiply_dynamic``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor

I32 = torch.int32


def _check_n(n: int) -> None:
    if not 1 <= n <= 31:
        raise ValueError(f"operand width n must be in [1, 31], got {n}")


def pr_multiply_plain(a: Tensor, b: Tensor, pr, *, n: int = 16) -> Tensor:
    """Plain version of :func:`pr_multiply`: the kernel's bit math in plain
    PyTorch int32 ops, step for step as ``_pr_kernel``."""
    _check_n(n)
    if a.is_cuda:
        _build.plain_cuda_calls["pr_multiply"] += 1
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
