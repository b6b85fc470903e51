"""Error metrics & evaluation harness for approximate multipliers (Ch. 4-6).

A numpy copy of ``repro.core.error_analysis`` (the port keeps its own).

Metrics follow the dissertation's definitions:

* RED  (relative error distance)     |P - P_hat| / |P|
* MRED (mean RED)                    mean over the operand distribution
* NMED (normalized mean error dist.) mean|P - P_hat| / max|P|
* PRED(t)                            Pr[RED <= t]   (paper reports PRED(2%))
* mean error (bias)                  mean (P_hat - P)  — the paper shows RAD's
                                     error distribution is near-zero-mean.

Evaluation styles:
* exhaustive over all operand pairs (n <= 8: 65k pairs, n <= 10: 1M pairs);
* sampled (uniform operands) for 16/32-bit;
* operand-marginal for RAD: because rel. error depends only on the encoded
  operand (Ch. 4 property), MRED = E_B |(B_hat - B)/B| *exactly* by enumerating
  the 2^n values of B — this is the paper's "accelerated error analysis".

The signal/vision metrics at the end (``mse``, ``snr_db``, ``psnr_db``,
``ssim``) are the stream workload's quality figures.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import encodings as enc


@dataclass
class ErrorReport:
    mred: float
    nmed: float
    max_red: float
    mean_err: float          # signed bias, normalized by max product
    error_rate: float        # fraction of pairs with any error
    pred2: float             # Pr[RED <= 2%]

    def row(self) -> str:
        return (
            f"mred={self.mred:.6f} nmed={self.nmed:.6f} max_red={self.max_red:.4f} "
            f"bias={self.mean_err:+.3e} er={self.error_rate:.4f} pred2={self.pred2:.4f}"
        )


def _report(p_exact: np.ndarray, p_approx: np.ndarray) -> ErrorReport:
    p_exact = p_exact.astype(np.float64)
    p_approx = p_approx.astype(np.float64)
    err = p_approx - p_exact
    nz = p_exact != 0
    red = np.zeros_like(err)
    red[nz] = np.abs(err[nz]) / np.abs(p_exact[nz])
    # where exact product is 0, RED is defined as 0 if approx is also 0 else inf;
    # the paper sidesteps 0 operands — we count them in NMED but clip RED.
    red[~nz & (err != 0)] = np.inf
    finite = np.isfinite(red)
    maxp = np.abs(p_exact).max() if p_exact.size else 1.0
    return ErrorReport(
        mred=float(red[finite].mean()) if finite.any() else 0.0,
        nmed=float(np.abs(err).mean() / max(maxp, 1e-30)),
        max_red=float(red[finite].max()) if finite.any() else 0.0,
        mean_err=float(err.mean() / max(maxp, 1e-30)),
        error_rate=float((err != 0).mean()),
        pred2=float((red[finite] <= 0.02).mean()) if finite.any() else 1.0,
    )


def evaluate_exhaustive(mult_fn, n: int) -> ErrorReport:
    """All operand pairs of an n-bit signed multiplier (n <= 10 sensible)."""
    vals = np.arange(-(1 << (n - 1)), 1 << (n - 1), dtype=np.int64)
    a, b = np.meshgrid(vals, vals, indexing="ij")
    exact = a * b
    approx = mult_fn(a, b)
    return _report(exact, approx)


def evaluate_sampled(mult_fn, n: int, num: int = 1 << 20, seed: int = 0) -> ErrorReport:
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (n - 1)), (1 << (n - 1)) - 1
    a = rng.integers(lo, hi + 1, size=num, dtype=np.int64)
    b = rng.integers(lo, hi + 1, size=num, dtype=np.int64)
    exact = a * b
    approx = mult_fn(a, b)
    return _report(exact, approx)


def rad_operand_marginal(n: int, k: int) -> ErrorReport:
    """Exact RAD error metrics by enumerating only B (the paper's accelerated
    method): RED(A,B) = |B_hat - B| / |B| for every A != 0."""
    b = np.arange(-(1 << (n - 1)), 1 << (n - 1), dtype=np.int64)
    b_hat = enc.np_rad_encode(b, n, k)
    err = (b_hat - b).astype(np.float64)
    nz = b != 0
    red = np.abs(err[nz]) / np.abs(b[nz]).astype(np.float64)
    maxb = float(1 << (n - 1))
    return ErrorReport(
        mred=float(red.mean()),
        nmed=float(np.abs(err).mean() / maxb),
        max_red=float(red.max()),
        mean_err=float(err.mean() / maxb),
        error_rate=float((err != 0).mean()),
        pred2=float((red <= 0.02).mean()),
    )


def evaluate_float(mult_fn, num: int = 1 << 18, seed: int = 0, scale: float = 4.0) -> ErrorReport:
    """Error metrics for an approximate float multiplier against exact fp64."""
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(num) * scale).astype(np.float32)
    b = (rng.standard_normal(num) * scale).astype(np.float32)
    exact = a.astype(np.float64) * b.astype(np.float64)
    approx = np.asarray(mult_fn(a, b), dtype=np.float64)
    return _report(exact, approx)


# ---------------------------------------------------------------------------
# signal/vision quality metrics (stream-workload calibration)
# ---------------------------------------------------------------------------
# The plan autotuner and the serve quality tap calibrate stream workloads on
# application-level quality (the approximate-computing surveys' requirement:
# PSNR/SSIM for signal & vision, not logit error).  All numpy-only, defined
# on arbitrary-shape arrays; ``ref`` is the exact-arithmetic output.


def mse(ref, x) -> float:
    """Mean squared error."""
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    return float(np.mean((ref - x) ** 2))


def snr_db(ref, x) -> float:
    """Signal-to-noise ratio in dB: signal power over error power (the
    dissertation's FIR quality figure; shared by bench_dsp and the DSP
    example — previously duplicated in both)."""
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    err = ref - x
    p_sig = float(np.mean(ref ** 2))
    p_err = float(np.mean(err ** 2))
    return float(10.0 * np.log10(p_sig / max(p_err, 1e-30)))


def psnr_db(ref, x, peak=None) -> float:
    """Peak signal-to-noise ratio in dB.  ``peak`` defaults to the
    reference's max magnitude (1.0 for an all-zero reference).  The MSE is
    floored at ``peak**2 * 1e-18`` (180 dB ceiling), so identical inputs
    give a large *finite* value — monotone in MSE, JSON-safe, and usable
    negated as a Pareto error axis (``-psnr_db``)."""
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    if peak is None:
        peak = float(np.max(np.abs(ref))) or 1.0
    m = max(mse(ref, x), float(peak) ** 2 * 1e-18)
    return float(10.0 * np.log10(float(peak) ** 2 / m))


def ssim(ref, x, peak=None) -> float:
    """Structural similarity (global-statistics variant, Wang et al. 2004
    constants C1=(0.01*peak)^2, C2=(0.03*peak)^2): luminance x contrast x
    structure over the whole array rather than a sliding window — the
    scale-invariant per-rung quality figure the bench gate checks.  Exactly
    1.0 on identical inputs; finite on constant signals (the stabilizing
    constants keep every denominator positive)."""
    ref = np.asarray(ref, np.float64)
    x = np.asarray(x, np.float64)
    if peak is None:
        peak = float(np.max(np.abs(ref))) or 1.0
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    mu_r, mu_x = float(np.mean(ref)), float(np.mean(x))
    var_r, var_x = float(np.var(ref)), float(np.var(x))
    cov = float(np.mean((ref - mu_r) * (x - mu_x)))
    return ((2 * mu_r * mu_x + c1) * (2 * cov + c2)
            / ((mu_r ** 2 + mu_x ** 2 + c1) * (var_r + var_x + c2)))
