"""Approximation policy: which technique, at what degree, on which layer.

This is the framework's first-class integration of the paper's methodology
(Ch. 7 + MAx-DNN fine-grained approximation): every matmul in the model zoo is
executed through ``approx_matmul(x, w, spec)`` and an ``ApproxPolicy`` maps
parameter paths (regex) to per-layer ``ApproxSpec`` — heterogeneous
approximation across the network, exactly the knob the paper explores
(Fig. 7.10-7.12: per-layer approximation of ResNet-8).

Modes
-----
EXACT       plain dot in the configured dtype (baseline).
AXQ         deployment path: block-quantized int8 GEMM with a runtime
            effective-bits degree (kernels/axqmm CUDA kernel) — the DyFXU
            analogue (perforation == dropped low bits, see DESIGN.md §2).
PR_EMUL     bit-exact AxFXU emulation on int8/int16-quantized operands
            (software-exploration stage of the Ch. 7 methodology).
RAD_EMUL    bit-exact RAD(k) emulation on quantized operands.
ROUP_EMUL   bit-exact ROUP(k,p,r) emulation on quantized operands.
POW2_W      weights snapped to powers of two (RAD's shift-only insight).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, replace
from enum import Enum
from typing import Sequence


class ApproxMode(str, Enum):
    EXACT = "exact"
    AXQ = "axq"
    PR_EMUL = "pr_emul"
    RAD_EMUL = "rad_emul"
    ROUP_EMUL = "roup_emul"
    POW2_W = "pow2_w"


@dataclass(frozen=True)
class ApproxSpec:
    mode: ApproxMode = ApproxMode.EXACT
    # PR / ROUP degrees (perforation rows, rounding bit)
    p: int = 0
    r: int = 0
    # hybrid high-radix k (RAD / ROUP)
    k: int = 8
    # emulation quantization lane width (bits) for *_EMUL modes
    lane_bits: int = 8
    # AXQ: effective operand bits (<= 8); 8 == plain int8
    ebits: int = 8
    # AXQ: quantization block size along the contraction dim
    block: int = 256
    # runtime-configurable degree (DyFXU): degree passed as traced scalar
    dynamic: bool = False

    def describe(self) -> str:
        if self.mode == ApproxMode.EXACT:
            return "exact"
        if self.mode == ApproxMode.AXQ:
            d = "dyn" if self.dynamic else "static"
            return f"axq(e{self.ebits},b{self.block},{d})"
        if self.mode == ApproxMode.PR_EMUL:
            return f"pr(p{self.p},r{self.r},n{self.lane_bits})"
        if self.mode == ApproxMode.RAD_EMUL:
            return f"rad(k{self.k},n{self.lane_bits})"
        if self.mode == ApproxMode.ROUP_EMUL:
            return f"roup(k{self.k},p{self.p},r{self.r},n{self.lane_bits})"
        return "pow2_w"


EXACT = ApproxSpec()


@dataclass
class ApproxPolicy:
    """Ordered (pattern -> spec) rules; first match wins; default EXACT.

    Example (the MAx-DNN experiment shape):
        ApproxPolicy([
            (r".*layers_[0-3]/.*", ApproxSpec(mode=ApproxMode.EXACT)),       # early layers exact
            (r".*mlp.*",           ApproxSpec(mode=ApproxMode.AXQ, ebits=6)),
            (r".*attn.*",          ApproxSpec(mode=ApproxMode.AXQ, ebits=8)),
        ])
    """

    rules: Sequence[tuple[str, ApproxSpec]] = field(default_factory=list)
    default: ApproxSpec = EXACT

    def spec_for(self, path: str) -> ApproxSpec:
        for pattern, spec in self.rules:
            if re.fullmatch(pattern, path) or re.search(pattern, path):
                return spec
        return self.default

    def with_degree(self, **kw) -> "ApproxPolicy":
        """Return a policy with every non-exact rule's degree fields replaced
        (used by the QoS controller to move the global degree)."""
        new_rules = [
            (pat, replace(spec, **kw) if spec.mode != ApproxMode.EXACT else spec)
            for pat, spec in self.rules
        ]
        new_default = (
            replace(self.default, **kw) if self.default.mode != ApproxMode.EXACT else self.default
        )
        return ApproxPolicy(new_rules, new_default)


def uniform(spec: ApproxSpec) -> ApproxPolicy:
    return ApproxPolicy(rules=[], default=spec)


def policy_from_flag(approx: str, dynamic: bool = False) -> ApproxPolicy:
    """One parser for the launchers' ``--approx`` flag: ``exact`` or ``axqN``
    (N in 1..8) -> a uniform policy.  Shared by launch.train and launch.serve
    so a model trained at a degree serves at the same spec (same block)."""
    if approx == "exact":
        return ApproxPolicy()
    m = re.fullmatch(r"axq([1-8])", approx)
    if not m:
        raise ValueError(
            f"--approx must be 'exact' or axqN with N in 1..8, got {approx!r}")
    return uniform(ApproxSpec(mode=ApproxMode.AXQ, ebits=int(m.group(1)),
                              dynamic=dynamic))
