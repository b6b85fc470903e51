"""Bit-level operand encodings from the dissertation (Ch. 3-6), in PyTorch.

A bit-exact emulation of the paper's encoders over int32 tensors (the port
of ``repro.core.encodings``): the torch functions run on any device; the
``np_*`` mirrors are numpy copies for wide-operand error studies.

Conventions
-----------
* An "n-bit operand" is a signed integer in [-2^(n-1), 2^(n-1)-1], stored in an
  int32 lane (n <= 16 keeps every intermediate product representable in int32;
  wider studies use the numpy/int64 helpers).
* Bit extraction is performed on the unsigned n-bit view ``u = x & (2^n - 1)``.
* Modified-Booth (radix-4) digits follow Table 4.1:
      y_j = -2*b_{2j+1} + b_{2j} + b_{2j-1},   b_{-1} = 0.
* The hybrid high-radix digit follows Eq. (4.3) and its approximation Table 4.2.

Integer semantics match the reference's: ``>>`` on int32 is an arithmetic
shift, ``<<`` wraps in two's complement, and int32 sums wrap (``dtype=
torch.int32``; a plain ``torch.sum`` of int32 would widen to int64).  A mask
``2^n - 1`` that does not fit an int32 lane raises ``OverflowError``, where
the reference's jitted call raises the same error.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

I32 = torch.int32

# ---------------------------------------------------------------------------
# Bit helpers
# ---------------------------------------------------------------------------


def _mask(n: int) -> int:
    return (1 << n) - 1


def _mask_i32(n: int) -> int:
    """``2^n - 1`` as an int32 operand; raises where it does not fit."""
    m = _mask(n)
    if m > 0x7FFFFFFF:
        raise OverflowError(f"mask 2^{n} - 1 does not fit an int32 lane")
    return m


def _i32(x) -> Tensor:
    return torch.as_tensor(x).to(I32)


def unsigned_view(x: Tensor, n: int) -> Tensor:
    """Unsigned n-bit view of a signed operand (two's complement)."""
    return _i32(x) & _mask_i32(n)


def bit(x: Tensor, i: int, n: int) -> Tensor:
    """i-th bit of the two's-complement n-bit representation of x."""
    return (unsigned_view(x, n) >> i) & 1


def to_signed(u: Tensor, n: int) -> Tensor:
    """Interpret an unsigned n-bit value as two's complement."""
    u = _i32(u) & _mask_i32(n)
    return torch.where(u >= (1 << (n - 1)), u - (1 << n), u)


# ---------------------------------------------------------------------------
# Radix-4 (Modified Booth) encoding  — Table 4.1 / Eq. (3.3)-(3.5)
# ---------------------------------------------------------------------------


def booth_digits(b: Tensor, n: int) -> Tensor:
    """Radix-4 Modified-Booth digits of an n-bit operand: int32 of shape
    ``b.shape + (n // 2,)``, digit j (LSB first) in {0, +-1, +-2}, with
    ``sum_j 4^j y_j == b``."""
    assert n % 2 == 0, "Modified Booth needs an even bit-width"
    b = _i32(b)
    digits = []
    for j in range(n // 2):
        b_hi = bit(b, 2 * j + 1, n)
        b_mid = bit(b, 2 * j, n)
        b_lo = bit(b, 2 * j - 1, n) if j > 0 else torch.zeros_like(b)
        digits.append(-2 * b_hi + b_mid + b_lo)
    return torch.stack(digits, dim=-1).to(I32)


def recombine_radix4(digits: Tensor) -> Tensor:
    """Inverse of :func:`booth_digits`: sum_j 4^j y_j (int32, wrapping)."""
    m = digits.shape[-1]
    weights = torch.tensor([4**j for j in range(m)], dtype=I32,
                           device=digits.device)
    return torch.sum(_i32(digits) * weights, dim=-1, dtype=I32)


# ---------------------------------------------------------------------------
# Partial-product perforation — Ch. 5 (AxFXU / DyFXU), Fig. 5.1
# ---------------------------------------------------------------------------


def perforate_operand(b: Tensor, n: int, p: int) -> Tensor:
    """Value of B after perforating the ``p`` least-significant radix-4
    partial products: B' = B - (B mod 2^{2p}) + 2^{2p} * b_{2p-1}.
    p = 0 is exact."""
    if p == 0:
        return _i32(b)
    assert 0 < p <= n // 2
    low = unsigned_view(b, n) & _mask_i32(2 * p)
    carry = bit(b, 2 * p - 1, n) * (1 << (2 * p))
    return (_i32(b) - low + carry).to(I32)


def round_operand(a: Tensor, r: int) -> Tensor:
    """Round the multiplicand at bit ``r`` (partial-product rounding, Ch. 5):
    A_r = (floor(A / 2^r) + a_{r-1}) * 2^r.  r = 0 is exact."""
    a = _i32(a)
    if r == 0:
        return a
    rb = (a >> (r - 1)) & 1            # arithmetic shift
    return ((a >> r) + rb) << r


# ---------------------------------------------------------------------------
# Hybrid high-radix encoding — Ch. 4 (RAD), Eq. (4.1)-(4.3), Tables 4.1/4.2
# ---------------------------------------------------------------------------


def highradix_digit(b: Tensor, n: int, k: int) -> Tensor:
    """Accurate radix-2^k digit of the k LSBs (Eq. 4.3), in
    [-2^(k-1), 2^(k-1)-1]."""
    assert k % 2 == 0 and 4 <= k <= n - 2
    low = unsigned_view(b, n) & _mask_i32(k)
    return to_signed(low, k)


def approx_highradix_digit(y0: Tensor, k: int) -> Tensor:
    """Approximate mapping of Table 4.2: snap y0 to the 4 largest powers of
    two (or 0), nearest-value intervals (thresholds doubled, as the
    reference does)."""
    y0 = _i32(y0)
    m2 = 2 * torch.abs(y0)
    full = lambda v: torch.full_like(y0, v)
    mag = torch.where(
        m2 < (1 << (k - 4)), torch.zeros_like(y0),
        torch.where(
            m2 < 3 * (1 << (k - 4)), full(1 << (k - 4)),
            torch.where(
                m2 < 3 * (1 << (k - 3)), full(1 << (k - 3)),
                torch.where(m2 < 3 * (1 << (k - 2)), full(1 << (k - 2)),
                            full(1 << (k - 1))))))
    return (torch.sign(y0) * mag).to(I32)


def rad_encode(b: Tensor, n: int, k: int) -> Tensor:
    """B-hat of the RAD multiplier: accurate radix-4 MSB part + approximate
    radix-2^k LSB digit."""
    y0 = highradix_digit(b, n, k)
    y0_hat = approx_highradix_digit(y0, k)
    high = _i32(b) - y0
    return high + y0_hat


# ---------------------------------------------------------------------------
# DLSB (double least-significant bit) — Ch. 3
# ---------------------------------------------------------------------------


def dlsb_value(x: Tensor, xp: Tensor) -> Tensor:
    """Value of a DLSB number X+ = <x>_2's + x_0+  (Eq. 3.1)."""
    return _i32(x) + _i32(xp)


def dlsb_encode_sophisticated(a: Tensor, ap: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """Sophisticated DLSB re-encoding (Eq. 3.9): A+ = (-1)^{a0+} * A' with
    a'_i = a_i XOR a0+.  Returns (A', a0+)."""
    u = unsigned_view(a, n)
    ap = _i32(ap)
    flip = torch.where(ap > 0, _mask_i32(n), 0).to(I32)
    return to_signed(u ^ flip, n), ap


def _b_plus_digits(b: Tensor, bp: Tensor, n: int) -> Tensor:
    """Booth digits of B+ (b_{-1} := b0+ in the least significant digit)."""
    digits = booth_digits(b, n)
    d0 = digits[..., 0] + _i32(bp)
    return torch.cat([d0[..., None], digits[..., 1:]], dim=-1)


def mult_dlsb_straightforward(a: Tensor, ap: Tensor, b: Tensor, bp: Tensor,
                              n: int) -> Tensor:
    """Straightforward DLSB multiplier (Eq. 3.6): MB product of A x B+ plus
    the extra term a0+ * B+."""
    b_plus = recombine_radix4(_b_plus_digits(b, bp, n))
    return _i32(a) * b_plus + _i32(ap) * b_plus


def mult_dlsb_sophisticated(a: Tensor, ap: Tensor, b: Tensor, bp: Tensor,
                            n: int) -> Tensor:
    """Sophisticated DLSB multiplier (Eq. 3.14): re-encode A+ as
    (-1)^{a0+}A', fold the sign into the Booth digits of B+."""
    a_prime, a0p = dlsb_encode_sophisticated(a, ap, n)
    digits = _b_plus_digits(b, bp, n)
    sign = torch.where(a0p > 0, -1, 1).to(I32)
    return recombine_radix4(digits * sign[..., None]) * a_prime


# ---------------------------------------------------------------------------
# Power-of-two snapping (RAD-inspired weight mode; DESIGN.md section 2.2)
# ---------------------------------------------------------------------------


#: the largest f32 below 2^-1/2: a mantissa m in [1/2, 1) lies nearer 1 than
#: 1/2 in the log domain exactly when m > this (no f32 equals 2^-1/2)
_RSQRT2_BELOW = 0.70710677


def pow2_snap(x: Tensor) -> Tensor:
    """Snap every element to the nearest signed power of two (or 0), f32.

    The exponent comes from ``frexp`` and one exact comparison of the
    mantissa with 2^-1/2, so the snap is the same bits on every device: a
    rounded ``log2`` puts an input within an ulp of 2^(k+1/2) on either
    side depending on the device's ``log2``.  Elsewhere it is the
    reference's ``round(log2 |x|)``."""
    x = torch.as_tensor(x)
    ax = torch.abs(x).to(torch.float32)
    m, e = torch.frexp(torch.clamp(ax, min=1e-30))
    e = torch.where(m > _RSQRT2_BELOW, e, e - 1)
    out = torch.sign(x).to(torch.float32) * torch.exp2(e.to(torch.float64)).to(torch.float32)
    return torch.where(ax == 0, torch.zeros_like(out), out)


# ---------------------------------------------------------------------------
# numpy mirrors (int64-exact, for wide-operand error studies)
# ---------------------------------------------------------------------------


def np_booth_digits(b: np.ndarray, n: int) -> np.ndarray:
    u = (b.astype(np.int64)) & _mask(n)
    ds = []
    for j in range(n // 2):
        hi = (u >> (2 * j + 1)) & 1
        mid = (u >> (2 * j)) & 1
        lo = ((u >> (2 * j - 1)) & 1) if j > 0 else np.zeros_like(u)
        ds.append(-2 * hi + mid + lo)
    return np.stack(ds, axis=-1)


def np_perforate_operand(b: np.ndarray, n: int, p: int) -> np.ndarray:
    if p == 0:
        return b.astype(np.int64)
    u = b.astype(np.int64) & _mask(n)
    low = u & _mask(2 * p)
    carry = ((u >> (2 * p - 1)) & 1) << (2 * p)
    return b.astype(np.int64) - low + carry


def np_round_operand(a: np.ndarray, r: int) -> np.ndarray:
    if r == 0:
        return a.astype(np.int64)
    a = a.astype(np.int64)
    rb = (a >> (r - 1)) & 1
    return ((a >> r) + rb) << r


def np_rad_encode(b: np.ndarray, n: int, k: int) -> np.ndarray:
    u = b.astype(np.int64) & _mask(n)
    low = u & _mask(k)
    y0 = np.where(low >= (1 << (k - 1)), low - (1 << k), low)
    m2 = 2 * np.abs(y0)
    mag = np.select(
        [
            m2 < (1 << (k - 4)),
            m2 < 3 * (1 << (k - 4)),
            m2 < 3 * (1 << (k - 3)),
            m2 < 3 * (1 << (k - 2)),
        ],
        [0, 1 << (k - 4), 1 << (k - 3), 1 << (k - 2)],
        default=1 << (k - 1),
    )
    y0_hat = np.sign(y0) * mag
    return b.astype(np.int64) - y0 + y0_hat
