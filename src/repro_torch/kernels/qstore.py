"""Quantized-weight residency: the quantize-once prepack layer (DESIGN.md §9).

AXQ weights are encoded once, at load time, into :class:`PackedQWeight` —
int8 values K-major plus f32 per-(row, k-block) scales — bit-identical to
what the on-the-fly path quantizes per call (same ``quantize_block``).  Only
the runtime effective-bits degree varies per call, and the kernels apply it
to the packed values, so one packed tree serves every rung of a QoS ladder.

:func:`prepack_params` walks the dense transformer's parameter tree
(``_pack_transformer``), including the separate ``unembed`` dense and the
tied-embedding ``unembed_q`` pack.  The ``*_EMUL`` packs and the other
model families are not ported yet.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.approx import ApproxMode, ApproxPolicy
from repro_torch.core.quantization import quantize_block

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def resolve_block(K: int, requested: int) -> int:
    """Largest power-of-two shrink of ``requested`` that divides ``K``;
    fails loudly on a non-positive block or contraction dim."""
    if requested <= 0:
        raise ValueError(f"quantization block must be positive, got {requested}")
    if K <= 0:
        raise ValueError(f"contraction dim must be positive, got {K}")
    block = min(requested, K)
    while K % block:
        block //= 2
        if block == 0:
            raise ValueError(f"no block divides K={K} (requested {requested})")
    return block


class PackedQWeight(NamedTuple):
    """AXQ weight residency: ``qw`` (..., N, K) int8 K-major and ``scales``
    (..., N, K // block) f32."""

    qw: Tensor
    scales: Tensor

    @property
    def k(self) -> int:
        return self.qw.shape[-1]

    @property
    def n(self) -> int:
        return self.qw.shape[-2]

    @property
    def block(self) -> int:
        return self.qw.shape[-1] // self.scales.shape[-1]


def is_packed(w) -> bool:
    return isinstance(w, PackedQWeight)


def prepack_weight(w: Tensor, block: int) -> PackedQWeight:
    """Quantize-once AXQ pack of ``w`` (..., K, N); leading dims (stacked
    layers) quantize per slice."""
    wT = w.to(torch.float32).transpose(-1, -2)
    qt = quantize_block(wT, block)
    return PackedQWeight(qt.values.contiguous(), qt.scales.contiguous())


def pack_for_spec(w, spec):
    """Pack one (..., K, N) weight for ``spec``; other modes (and weights
    already packed) come back unchanged."""
    if is_packed(w):
        return w
    if spec.mode == ApproxMode.AXQ:
        return prepack_weight(w, resolve_block(w.shape[-2], spec.block))
    if spec.mode != ApproxMode.EXACT:
        raise NotImplementedError(
            f"prepack for {spec.mode.value} is not ported (AXQ only)")
    return w


def _pack_dense(p: dict, path: str, policy: ApproxPolicy) -> dict:
    """Pack one init_dense param dict ({"w": tensor[, "b": tensor]})."""
    packed = pack_for_spec(p["w"], policy.spec_for(path))
    if packed is p["w"]:
        return p
    return {**p, "w": packed}


def _pack_gated_mlp(p: dict, path: str, policy: ApproxPolicy) -> dict:
    return {k: _pack_dense(v, f"{path}/{k}", policy) for k, v in p.items()}


def _pack_embed(p: dict, policy: ApproxPolicy) -> dict:
    """Tied unembedding: logits = x @ emb.T, so the K-major pack of
    ``emb.T`` quantizes ``emb`` itself.  The pack rides the embed dict as
    ``unembed_q``; the token-lookup ``emb`` stays float."""
    spec = policy.spec_for("unembed")
    if spec.mode == ApproxMode.EXACT or "unembed_q" in p:
        return p
    packed = pack_for_spec(p["emb"].transpose(-1, -2), spec)
    if not is_packed(packed):
        return p
    return {**p, "unembed_q": packed}


def _pack_transformer(params: dict, cfg, policy: ApproxPolicy) -> dict:
    out = dict(params)
    layers = dict(params["layers"])
    for key in ("wq", "wk", "wv", "wo"):
        layers[key] = _pack_dense(layers[key], f"layer/{key}", policy)
    layers["mlp"] = _pack_gated_mlp(layers["mlp"], "layer/mlp", policy)
    out["layers"] = layers
    if "unembed" in params:
        out["unembed"] = _pack_dense(params["unembed"], "unembed", policy)
    elif cfg.tie_embeddings:
        out["embed"] = _pack_embed(params["embed"], policy)
    return out


def prepack_params(params: dict, cfg, policy: ApproxPolicy) -> dict:
    """Quantize-once pass over a dense transformer's param tree: every dense
    weight whose policy spec is AXQ becomes a :class:`PackedQWeight`.
    Idempotent; EXACT-only policies return every tensor untouched.  The
    result is inference-only (int8 leaves carry no gradients)."""
    if cfg.family != "dense" or cfg.moe or cfg.frontend:
        raise NotImplementedError(
            f"prepack_params is ported for the dense family only, not "
            f"{cfg.name!r} ({cfg.family})")
    return _pack_transformer(params, cfg, policy)
