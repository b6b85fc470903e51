"""Unit-gate area/energy proxy model (the port of ``repro.core.area_model``) — reimplements the dissertation's model
(Tables 3.2, 3.3, 4.4, 4.5) so every approximate configuration gets the same
area/energy ranking the paper uses for its Pareto fronts.

Unit-gate costs (Ch. 3, "unit gate model used in [240]"):
    AND-2 / OR-2 = 1,  NOT = 0.5,  XOR-2 = 2,  FA = 7,  HA = 3,
    MB encoder = 5.5,  DLSB MB encoder = 7.5,  MB PP generator = 5 per bit,
    AND PP generator = 1 per bit,  correction-term generator = 2,
    prefix propagate group = 3.

The model reproduces the paper's Table 3.3 overheads exactly
(DLSB2: 1.4 / 0.8 / 0.5 %, DLSB1: 11.8 / 6.7 / 3.7 % for n = 8/16/32) —
asserted in tests/test_area_model.py; tests/test_torch_tune.py holds this
copy to the reference float for float.

Energy proxy: the paper measures energy = power x delay at the synthesized
critical path.  Gate-level power tracks switched capacitance ~ gate count, and
tree depth tracks delay, so we expose  energy_proxy = area * log2(#pp rows),
documented as a *ranking* proxy (it reproduces the paper's orderings, not its
absolute nJ numbers).
"""

from __future__ import annotations

import math

AND = OR = 1.0
NOT = 0.5
XOR = 2.0
FA = 7.0
HA = 3.0
MB_ENC = 5.5
DLSB_MB_ENC = 7.5
MB_PPGEN_BIT = 5.0
AND_PPGEN_BIT = 1.0
CORR = 2.0
PG = 3.0


def _final_adder(n: int) -> float:
    """Fast prefix adder on the 2n-bit carry-save output (Ch. 3 model):
    2n HAs + n*log2(2n) propagate groups + 2n XORs."""
    return 2 * n * HA + n * math.log2(2 * n) * PG + 2 * n * XOR


def _tree(rows: int, width: int) -> float:
    """Carry-save accumulation of `rows` vectors of `width` bits: each FA row
    reduces 3 vectors to 2, so (rows - 2) * width FAs (Ch. 3: "n/2 + 1 vectors
    ... (n/2 - 1) x n full adders")."""
    return max(rows - 2, 0) * width * FA


def area_cmb(n: int) -> float:
    """Conventional Modified-Booth multiplier (exact baseline)."""
    rows = n // 2
    return (
        rows * MB_ENC
        + rows * (n + 1) * MB_PPGEN_BIT
        + rows * CORR
        + rows * NOT                      # inverted MSB per partial product
        + _tree(rows + 1, n)              # rows PPs + constants/corrections row
        + _final_adder(n)
    )


def area_dlsb1(n: int) -> float:
    """Straightforward DLSB multiplier: CMB + (n+1) AND + NOT + one extra
    accumulated row (Table 3.2: n/2 x n FAs instead of (n/2-1) x n)."""
    return area_cmb(n) + (n + 1) * AND_PPGEN_BIT + NOT + n * FA


def area_dlsb2(n: int) -> float:
    """Sophisticated DLSB multiplier: CMB with DLSB MB encoders (Table 3.2)."""
    return area_cmb(n) + (n // 2) * (DLSB_MB_ENC - MB_ENC)


def area_rad(n: int, k: int) -> float:
    """RAD hybrid high-radix multiplier (Ch. 4): (n-k)/2 radix-4 PPs plus one
    shift-only high-radix PP.  The approximate high-radix encoder costs about
    2x the radix-4 encoder (stated in Ch. 4); its PP is produced by a shifter
    modelled as AND-level muxing over the 5 possible shifts."""
    rows4 = (n - k) // 2
    enc_cost = rows4 * MB_ENC + 2 * MB_ENC
    ppgen = rows4 * (n + 1) * MB_PPGEN_BIT + (n + k) * 5 * AND_PPGEN_BIT
    corr = (rows4 + 1) * CORR + (rows4 + 1) * NOT
    return enc_cost + ppgen + corr + _tree(rows4 + 2, n) + _final_adder(n)


def area_pr(n: int, p: int, r: int) -> float:
    """Perforation+rounding multiplier (Ch. 5): p rows removed; each remaining
    PP is (n + 1 - r) bits wide; rounding adds one row of correction bits,
    folded into the constants row (no extra row)."""
    rows = n // 2 - p
    return (
        rows * MB_ENC
        + rows * (n + 1 - r) * MB_PPGEN_BIT
        + rows * CORR
        + rows * NOT
        + _tree(rows + 1, n - r)
        + _final_adder(n)
    )


def area_roup(n: int, k: int, p: int, r: int) -> float:
    """Cooperative ROUP multiplier (Ch. 6): RAD(k) with p radix-4 rows
    perforated and operand rounding at bit r."""
    rows4 = max((n - k) // 2 - p, 0)
    enc_cost = rows4 * MB_ENC + 2 * MB_ENC
    ppgen = rows4 * (n + 1 - r) * MB_PPGEN_BIT + (n + k - r) * 5 * AND_PPGEN_BIT
    corr = (rows4 + 1) * CORR + (rows4 + 1) * NOT
    return enc_cost + ppgen + corr + _tree(rows4 + 2, n - r) + _final_adder(n)


def rows_of(fam: str, n: int, k: int, p: int) -> int:
    if fam in ("RAD",):
        return (n - k) // 2 + 1
    if fam == "ROUP":
        return max((n - k) // 2 - p, 0) + 1
    return n // 2 - p


def area_of(fam: str, n: int, k: int = 0, p: int = 0, r: int = 0) -> float:
    if fam in ("PERF", "ROUND", "PR", "CMB"):
        return area_pr(n, p, r) if fam != "CMB" else area_cmb(n)
    if fam == "RAD":
        return area_rad(n, k)
    if fam == "ROUP":
        return area_roup(n, k, p, r)
    raise ValueError(fam)


def energy_proxy(fam: str, n: int, k: int = 0, p: int = 0, r: int = 0) -> float:
    """area x log2(rows+1): switched capacitance x tree-depth delay proxy."""
    rows = rows_of(fam, n, k, p) if fam != "CMB" else n // 2
    return area_of(fam, n, k, p, r) * math.log2(rows + 1)


def dlsb_overhead_table() -> dict[int, tuple[float, float]]:
    """Reproduces Table 3.3: % unit-gate overhead of DLSB1/DLSB2 vs CMB."""
    out = {}
    for n in (8, 16, 32):
        base = area_cmb(n)
        out[n] = (
            100.0 * (area_dlsb1(n) - base) / base,
            100.0 * (area_dlsb2(n) - base) / base,
        )
    return out
