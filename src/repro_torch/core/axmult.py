"""The dissertation's approximate multiplier families, bit-exact in PyTorch
(the port of ``repro.core.axmult``).

Families (all return exact integer products of *transformed* operands, which
is precisely what the hardware computes — the approximation lives entirely in
the operand/partial-product transformation):

=========  =========================================  ==================
family     transformation                             paper
=========  =========================================  ==================
CMB        none (exact Modified-Booth)                Ch. 3 baseline
DLSB       exact product of DLSB numbers              Ch. 3
RAD(k)     B -> rad_encode(B, n, k)                   Ch. 4
PERF(p)    B -> perforate_operand(B, n, p)            Ch. 5 (perforation)
ROUND(r)   A -> round_operand(A, r)                   Ch. 5 (rounding)
PR(p,r)    both of the above (AxFXU / DyFXU)          Ch. 5
ROUP(k,    RAD(k) on B + rounding(r) on A +           Ch. 6 (cooperative)
  p,r)     perforation(p) of the radix-4 MSB part
AxFPU      PR applied to the significand product      Ch. 5 (floating pt)
=========  =========================================  ==================

Runtime-configurable variants (DyFXU/DyFPU) take ``p``/``r`` as int32
tensors (:func:`pr_multiply_dynamic`): one circuit, the degree selected by a
device value, nothing rebuilt.  ``pr_multiply_dynamic`` is the oracle of the
``pr_multiply`` kernel (``kernels/axmult_elem.py``).

Bit-width contract: operands are n-bit signed with n <= 16 so int32 lanes hold
every product (|A_r| <= 2^(n-1), |B-hat| < 2^n => |prod| < 2^(2n-1) <= 2^31).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from . import encodings as enc

Tensor = torch.Tensor

I32 = torch.int32

# ---------------------------------------------------------------------------
# Fixed point
# ---------------------------------------------------------------------------


def mult_exact(a: Tensor, b: Tensor) -> Tensor:
    return enc._i32(a) * enc._i32(b)


def mult_rad(a: Tensor, b: Tensor, n: int, k: int) -> Tensor:
    """RAD_2^k approximate multiplier (Ch. 4): A x rad_encode(B)."""
    return enc._i32(a) * enc.rad_encode(b, n, k)


def mult_pr(a: Tensor, b: Tensor, n: int, p: int, r: int) -> Tensor:
    """Perforation(p)+Rounding(r) multiplier (AxFXU, Ch. 5)."""
    return enc.round_operand(a, r) * enc.perforate_operand(b, n, p)


def mult_roup(a: Tensor, b: Tensor, n: int, k: int, p: int, r: int) -> Tensor:
    """Cooperative ROUP multiplier (Ch. 6): hybrid high-radix encoding of B,
    perforation of the p radix-4 digits just above the high-radix digit
    (digits [k/2, k/2 + p)), and rounding of A at bit r."""
    b_hat = enc.rad_encode(b, n, k)
    if p > 0:
        y0 = enc.highradix_digit(b, n, k)
        high = enc._i32(b) - y0                            # radix-4 part value
        hi_perf = enc.perforate_operand(high, 2 * n, k // 2 + p)
        b_hat = hi_perf + (b_hat - high)
    return enc.round_operand(a, r) * b_hat


def mult_dlsb(a: Tensor, ap: Tensor, b: Tensor, bp: Tensor, n: int) -> Tensor:
    """Exact DLSB multiplier via the sophisticated encoding (Ch. 3)."""
    return enc.mult_dlsb_sophisticated(a, ap, b, bp, n)


# Runtime-configurable (DyFXU): p and r are int32 tensors. ------------------


def perforate_dynamic(b: Tensor, n: int, p: Tensor) -> Tensor:
    """Perforation with a runtime degree p in [0, n/2]: the closed form
    B' = B - (B mod 2^{2p}) + 2^{2p} b_{2p-1}, selected on p > 0 (the
    paper's runtime configuration mux, Fig. 5.3)."""
    b = enc._i32(b)
    p = enc._i32(p).to(b.device)
    u = b & enc._mask_i32(n)
    two_p = torch.ones((), dtype=I32, device=b.device) << (2 * p)
    low = u & (two_p - 1)
    shift = torch.clamp(2 * p - 1, min=0)
    carry_bit = (u >> shift) & 1
    carry = torch.where(p > 0, carry_bit * two_p, 0)
    return b - low + carry


def round_dynamic(a: Tensor, r: Tensor) -> Tensor:
    a = enc._i32(a)
    r = enc._i32(r).to(a.device)
    rb = torch.where(r > 0, (a >> torch.clamp(r - 1, min=0)) & 1, 0)
    rounded = ((a >> r) + rb) << r
    return torch.where(r > 0, rounded, a)


def pr_multiply_dynamic(a: Tensor, b: Tensor, n: int, p: Tensor, r: Tensor) -> Tensor:
    """DyFXU: PR multiplier whose degree (p, r) is a runtime value."""
    return round_dynamic(a, r) * perforate_dynamic(b, n, p)


# ---------------------------------------------------------------------------
# Floating point (AxFPU / DyFPU) — PR on the significand product
# ---------------------------------------------------------------------------

_FLOAT_FMTS = {
    # name: (torch dtype, exponent bits, mantissa bits)
    "bf16": (torch.bfloat16, 8, 7),
    "fp16": (torch.float16, 5, 10),
    "fp32": (torch.float32, 8, 23),
}


def _decompose(x: Tensor, fmt: str):
    dtype, ebits, mbits = _FLOAT_FMTS[fmt]
    x = torch.as_tensor(x).to(dtype)
    if 1 + ebits + mbits == 16:
        raw = x.view(torch.int16).to(I32) & 0xFFFF
    else:
        raw = x.view(I32)
    sign = (raw >> (ebits + mbits)) & 1
    exp = (raw >> mbits) & ((1 << ebits) - 1)
    man = raw & ((1 << mbits) - 1)
    return sign, exp, man, ebits, mbits, dtype


def axfpu_multiply(a: Tensor, b: Tensor, fmt: str = "bf16", p: int = 0,
                   r: int = 0) -> Tensor:
    """AxFPU (Ch. 5): exact exponent addition, PR-approximate significand
    product, truncating renormalization; subnormals flush to zero.  bf16
    and fp16 in int32 lanes; fp32 studies use :func:`np_axfpu_multiply`."""
    if fmt == "fp32":
        raise ValueError("in-graph AxFPU supports bf16/fp16; use np_axfpu_multiply for fp32")
    sa, ea, ma, ebits, mbits, dtype = _decompose(a, fmt)
    sb, eb, mb, *_ = _decompose(b, fmt)
    bias = (1 << (ebits - 1)) - 1
    nsig = mbits + 1
    siga = torch.where(ea > 0, ma + (1 << mbits), 0)
    sigb = torch.where(eb > 0, mb + (1 << mbits), 0)
    # PR transform on an even lane width wide enough that the (unsigned)
    # significand is positive in the lane's two's-complement view
    n_lane = 2 * ((nsig + 2) // 2)
    siga_t = enc.round_operand(siga, r)
    sigb_t = enc.perforate_operand(sigb, n_lane, p) if p > 0 else sigb
    prod = siga_t * sigb_t
    top = prod >> (2 * mbits + 1)          # 1 if product >= 2^(2m+1)
    man_out = (prod >> (mbits + top)) & ((1 << mbits) - 1)   # truncating
    exp_out = ea + eb - bias + top
    sign_out = sa ^ sb
    max_exp = (1 << ebits) - 1
    zero = (prod == 0) | (exp_out <= 0)
    inf = exp_out >= max_exp
    exp_out = torch.clamp(exp_out, 0, max_exp)
    raw = ((sign_out << (ebits + mbits))
           + (torch.where(inf, max_exp, exp_out) << mbits)
           + torch.where(inf, 0, man_out))
    raw = torch.where(zero, sign_out << (ebits + mbits), raw)
    if 1 + ebits + mbits == 16:
        return raw.to(torch.int16).view(dtype)
    return raw.to(I32).view(dtype)


# ---------------------------------------------------------------------------
# numpy mirrors (wide operands, exhaustive error studies)
# ---------------------------------------------------------------------------


def np_mult_rad(a: np.ndarray, b: np.ndarray, n: int, k: int) -> np.ndarray:
    return a.astype(np.int64) * enc.np_rad_encode(b, n, k)


def np_mult_pr(a: np.ndarray, b: np.ndarray, n: int, p: int, r: int) -> np.ndarray:
    return enc.np_round_operand(a, r) * enc.np_perforate_operand(b, n, p)


def np_mult_roup(a: np.ndarray, b: np.ndarray, n: int, k: int, p: int, r: int) -> np.ndarray:
    b_hat = enc.np_rad_encode(b, n, k)
    if p > 0:
        u = b.astype(np.int64) & ((1 << n) - 1)
        low = u & ((1 << k) - 1)
        y0 = np.where(low >= (1 << (k - 1)), low - (1 << k), low)
        high = b.astype(np.int64) - y0
        hi_perf = enc.np_perforate_operand(high, 2 * n, k // 2 + p)
        b_hat = hi_perf + (b_hat - high)
    return enc.np_round_operand(a, r) * b_hat


def np_axfpu_multiply(a: np.ndarray, b: np.ndarray, p: int = 0, r: int = 0) -> np.ndarray:
    """fp32 AxFPU in numpy int64 lanes (24-bit significands, 48-bit products)."""
    ra = a.astype(np.float32).view(np.int32).astype(np.int64)
    rb = b.astype(np.float32).view(np.int32).astype(np.int64)
    sa, ea, ma = (ra >> 31) & 1, (ra >> 23) & 0xFF, ra & 0x7FFFFF
    sb, eb, mb = (rb >> 31) & 1, (rb >> 23) & 0xFF, rb & 0x7FFFFF
    siga = np.where(ea > 0, ma + (1 << 23), 0)
    sigb = np.where(eb > 0, mb + (1 << 23), 0)
    siga_t = enc.np_round_operand(siga, r)
    sigb_t = enc.np_perforate_operand(sigb, 24, p) if p > 0 else sigb
    prod = siga_t * sigb_t
    top = (prod >> 47) & 1
    man_out = (prod >> (23 + top)) & 0x7FFFFF
    exp_out = ea + eb - 127 + top
    sign_out = sa ^ sb
    zero = (prod == 0) | (exp_out <= 0)
    inf = exp_out >= 255
    exp_out = np.clip(exp_out, 0, 255)
    raw = (sign_out << 31) + (np.where(inf, 255, exp_out) << 23) + np.where(inf, 0, man_out)
    raw = np.where(zero, sign_out << 31, raw)
    return (raw & 0xFFFFFFFF).astype(np.uint32).view(np.float32)


# ---------------------------------------------------------------------------
# Family registry (pareto exploration + benchmarks)
# ---------------------------------------------------------------------------


def family_configs(n: int = 16):
    """Enumerate the dissertation's approximation space for n-bit operands:
    (name, callable(a, b) -> product, meta-dict), the Ch. 6 pool PERF,
    ROUND, PR, RAD, ROUP."""
    out = []
    for p in range(1, 5):
        out.append((f"PERF{p}", partial(np_mult_pr, n=n, p=p, r=0), dict(fam="PERF", p=p, r=0, k=0)))
    for r in range(2, 11, 2):
        out.append((f"ROUND{r}", partial(np_mult_pr, n=n, p=0, r=r), dict(fam="ROUND", p=0, r=r, k=0)))
    for p in range(1, 4):
        for r in range(2, 9, 2):
            out.append((f"PR{p}_{r}", partial(np_mult_pr, n=n, p=p, r=r), dict(fam="PR", p=p, r=r, k=0)))
    for k in range(4, min(n - 2, 12) + 1, 2):
        out.append((f"RAD{2**k}", partial(np_mult_rad, n=n, k=k), dict(fam="RAD", p=0, r=0, k=k)))
    for k in (4, 6, 8):
        for p in (0, 1, 2):
            for r in (0, 2, 4):
                if p == 0 and r == 0:
                    continue
                out.append(
                    (
                        f"ROUP{k}_{p}_{r}",
                        partial(np_mult_roup, n=n, k=k, p=p, r=r),
                        dict(fam="ROUP", p=p, r=r, k=k),
                    )
                )
    return out
