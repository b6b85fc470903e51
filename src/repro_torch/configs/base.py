"""Architecture & shape configuration system.

Every assigned architecture is a frozen ``ArchConfig``; every workload shape a
``ShapeCfg``.  ``padded(tp)`` derives the mesh-divisible physical dimensions
(heads / kv / experts / vocab padded to the tensor-parallel degree) while the
logical dimensions stay authoritative for parameter export & FLOP accounting.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    d_shared: int = 0
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclass(frozen=True)
class ShapeCfg:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeCfg] = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class PaddedDims:
    n_heads: int
    n_kv_rep: int      # kv heads after repeat-to-TP (cache/attention layout)
    q_group: int       # padded q heads per kv_rep head
    vocab: int
    n_experts: int
    d_ff: int


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    swa_window: Optional[int] = None        # sliding-window attention (danube)
    local_window: Optional[int] = None      # local attention (recurrentgemma)
    block_pattern: Optional[tuple[str, ...]] = None  # hybrid stacking unit
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    frontend: Optional[str] = None          # "vision" | "audio" (stub)
    frontend_dim: int = 0
    frontend_tokens: int = 0                # img patches / audio frames in seq
    norm_eps: float = 1e-6
    causal: bool = True
    tie_embeddings: bool = False
    act: str = "silu"
    dtype: str = "bfloat16"
    source: str = ""

    # ---- derived -----------------------------------------------------------

    def padded(self, tp: int) -> PaddedDims:
        """Physical dims for a given tensor-parallel degree (DESIGN.md §3)."""
        n_heads = pad_to(self.n_heads, tp) if self.n_heads else 0
        if self.n_kv_heads:
            kv_rep = tp if self.n_kv_heads <= tp else pad_to(self.n_kv_heads, tp)
            kv_rep = min(kv_rep, n_heads) if n_heads else kv_rep
            kv_rep = max(kv_rep, 1)
            # q_group must be a positive integer
            while n_heads % kv_rep:
                kv_rep //= 2
            q_group = n_heads // kv_rep
        else:
            kv_rep, q_group = 0, 0
        n_exp = pad_to(self.moe.n_experts, tp) if self.moe else 0
        return PaddedDims(
            n_heads=n_heads,
            n_kv_rep=kv_rep,
            q_group=q_group,
            vocab=pad_to(self.vocab, tp),
            n_experts=n_exp,
            d_ff=pad_to(self.d_ff, tp) if self.d_ff else 0,
        )

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def encoder_only(self) -> bool:
        return self.family == "audio"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run long_500k (decode w/ bounded state)?"""
        return (
            self.family in ("ssm", "hybrid")
            or (self.swa_window is not None)
        )

    def valid_shapes(self) -> dict[str, ShapeCfg | None]:
        """shape name -> ShapeCfg if runnable else None (skip + reason table
        is produced by launch.dryrun)."""
        out: dict[str, ShapeCfg | None] = {}
        for name, s in SHAPES.items():
            if s.kind == "decode" and self.encoder_only:
                out[name] = None
            elif name == "long_500k" and not self.sub_quadratic:
                out[name] = None
            else:
                out[name] = s
        return out

    def skip_reason(self, shape_name: str) -> str | None:
        if self.valid_shapes()[shape_name] is not None:
            return None
        if self.encoder_only:
            return "encoder-only arch has no decode step"
        return "pure full-attention arch: no sub-quadratic path for 500k decode"

    # ---- parameter count (logical, for MODEL_FLOPS) ------------------------

    def param_count(self) -> tuple[int, int]:
        """(total_params, active_params) — active differs for MoE."""
        d, L, V = self.d_model, self.n_layers, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer_attn = 0
        if self.n_heads:
            qd = self.n_heads * self.head_dim
            kvd = self.n_kv_heads * self.head_dim
            per_layer_attn = d * qd + 2 * d * kvd + qd * d

        def ffn_dense(dff):
            return 3 * d * dff  # gated (up, gate, down)

        total = emb
        active = emb
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            per = (
                d * (2 * d_in + 2 * s.d_state + d_in // s.headdim)  # in_proj
                + d_in * d                                          # out_proj
                + s.conv_width * (d_in + 2 * s.d_state)
            )
            total += L * per
            active = total
            return total, active

        if self.family == "hybrid":
            # recurrent blocks: wx, wg, wa, wi, wo (5 d^2) + conv + gates;
            # attn blocks: standard attention.  Both carry the gated MLP.
            pat = self.block_pattern or ("attn",)
            n_attn = sum(1 for i in range(L) if pat[i % len(pat)] == "attn")
            n_rec = L - n_attn
            rec_per = 5 * d * d + 5 * d  # projections + conv(4d) + lambda
            total += n_attn * (per_layer_attn + ffn_dense(self.d_ff) + 2 * d)
            total += n_rec * (rec_per + ffn_dense(self.d_ff) + 2 * d)
            return total, total

        per_layer = per_layer_attn + 2 * d  # + norms
        if self.moe:
            m = self.moe
            router = d * m.n_experts
            experts = m.n_experts * 3 * d * m.d_expert
            shared = m.n_shared * 3 * d * m.d_shared
            total += L * (per_layer + router + experts + shared)
            active += L * (
                per_layer + router + m.top_k * 3 * d * m.d_expert + shared
            )
        else:
            total += L * (per_layer + ffn_dense(self.d_ff))
            active = total
        return total, active


# ---------------------------------------------------------------------------
# Reduced smoke variants (per-arch family, tiny dims, CPU-runnable)
# ---------------------------------------------------------------------------


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Same family/topology, tiny dims — used by per-arch smoke tests."""
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=len(cfg.block_pattern) if cfg.block_pattern else 2,
        d_model=64,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        frontend_dim=32 if cfg.frontend else 0,
        frontend_tokens=8 if cfg.frontend else 0,
    )
    if cfg.moe:
        kw["moe"] = MoECfg(
            n_experts=8,
            top_k=min(cfg.moe.top_k, 2),
            d_expert=64,
            n_shared=min(cfg.moe.n_shared, 1),
            d_shared=64 if cfg.moe.n_shared else 0,
        )
    if cfg.ssm:
        kw["ssm"] = SSMCfg(d_state=16, headdim=16, expand=2, chunk=16, conv_width=4)
    if cfg.swa_window:
        kw["swa_window"] = 32
    if cfg.local_window:
        kw["local_window"] = 32
    return replace(cfg, **kw)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # import the per-arch modules lazily so `register` runs
    from . import all_archs  # noqa: F401

    if name.endswith("-smoke"):
        return smoke_variant(get_config(name[: -len("-smoke")]))
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    from . import all_archs  # noqa: F401

    return sorted(_REGISTRY)
