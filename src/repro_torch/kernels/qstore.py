"""Quantized-weight residency: the quantize-once prepack layer (DESIGN.md §9).

AXQ weights are encoded once, at load time, into :class:`PackedQWeight` —
int8 values K-major plus f32 per-(row, k-block) scales — bit-identical to
what the on-the-fly path quantizes per call (same ``quantize_block``).  Only
the runtime effective-bits degree varies per call, and the kernels apply it
to the packed values, so one packed tree serves every rung of a QoS ladder.

The ``*_EMUL`` modes pack into :class:`PackedEmulWeight`: a per-tensor int8
weight (one scale per stacked-layer slice) with the static operand
transform — perforation, RAD or ROUP encoding — already applied, again
bit-identical to the per-call transform.  Its ``qw`` is the (..., K, N)
operand of ``torch._int_mm`` in the layout that call takes on the card:
column-major, a transposed view of an (..., N, K) buffer (set once here and
in ``convert``, never per call).

:func:`prepack_params` walks the dense and MoE transformers' parameter
tree (``_pack_transformer``), including the separate ``unembed`` dense,
the tied-embedding ``unembed_q`` pack, and an MoE layer's experts (packed
per (layer, expert) slice when they route AXQ) and shared experts, and
the SSM and hybrid trees.

On a mesh (tensor parallelism) the packs are built on this rank's shards,
after slicing (``dist/sharding.py``).  A column-parallel or expert shard
packs as the matching slice of the global pack would.  A row-parallel
shard (``wo``, ``down``, ``out_proj``, in every family: rows of the contraction dim) takes
the block resolved from the *global* K (``resolve_block(K_local * tp,
block)``), and a shard that is not a whole number of those blocks raises,
naming the leaf: quantizing other blocks than one device's would change
the arithmetic.  The *_EMUL modes raise on a mesh: their per-tensor scale
is the whole tensor's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core import encodings as enc
from repro_torch.core.approx import ApproxMode, ApproxPolicy, ApproxSpec
from repro_torch.core.quantization import quantize_block
from repro_torch.dist.sharding import is_row_parallel

Tensor = torch.Tensor

_EMUL_MODES = (ApproxMode.PR_EMUL, ApproxMode.RAD_EMUL, ApproxMode.ROUP_EMUL)


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


class PackedEmulWeight(NamedTuple):
    """*_EMUL weight residency: ``qw`` (..., K, N) int8, per-tensor
    quantized with the static operand transform applied, column-major in
    its last two dims; ``scale`` (...,) f32, one per leading slice."""

    qw: Tensor
    scale: Tensor

    @property
    def k(self) -> int:
        return self.qw.shape[-2]

    @property
    def n(self) -> int:
        return self.qw.shape[-1]


def emul_layout(qw: Tensor) -> Tensor:
    """``qw`` (..., K, N) as a transposed view of a contiguous (..., N, K)
    buffer: the column-major second operand ``torch._int_mm`` takes."""
    return qw.transpose(-1, -2).contiguous().transpose(-1, -2)


def is_packed(w) -> bool:
    return isinstance(w, (PackedQWeight, PackedEmulWeight))


def prepack_weight(w: Tensor, block: int) -> PackedQWeight:
    """Quantize-once AXQ pack of ``w`` (..., K, N); leading dims (stacked
    layers) quantize per slice."""
    wT = w.to(torch.float32).transpose(-1, -2)
    qt = quantize_block(wT, block)
    return PackedQWeight(qt.values.contiguous(), qt.scales.contiguous())


def _quantize_per_tensor_sliced(w: Tensor, bits: int):
    """Per-tensor symmetric quantization over the trailing (K, N) dims — per
    slice for stacked weights, as each layer's 2-D weight quantizes per
    call.  Returns (int32 codes, f32 scale (...,))."""
    qmax = (1 << (bits - 1)) - 1
    w = w.to(torch.float32)
    amax = torch.clamp(w.abs().amax(dim=(-2, -1)), min=1e-30)
    scale = amax / qmax
    q = torch.clamp(torch.round(w / scale[..., None, None]), -qmax, qmax)
    return q.to(torch.int32), scale


def emul_weight_transform(qw: Tensor, spec: ApproxSpec) -> Tensor:
    """The static weight-operand transform of the *_EMUL modes (int32
    lanes), shared by the on-the-fly path and the prepack."""
    n = spec.lane_bits
    if spec.mode == ApproxMode.PR_EMUL:
        return enc.perforate_operand(qw, n, spec.p) if spec.p else qw
    if spec.mode == ApproxMode.RAD_EMUL:
        return enc.rad_encode(qw, n, spec.k)
    if spec.mode == ApproxMode.ROUP_EMUL:
        qw = enc.rad_encode(qw, n, spec.k)
        # perforation of the radix-4 digits above the high-radix digit
        if spec.p:
            y0 = enc.highradix_digit(qw, n, spec.k)
            high = qw - y0
            qw = enc.perforate_operand(high, 2 * n, spec.k // 2 + spec.p) + y0
        return qw
    raise ValueError(f"not an emulation mode: {spec.mode}")


def prepack_emul_weight(w: Tensor, spec: ApproxSpec) -> PackedEmulWeight:
    """Quantize and transform the weight operand once for a *_EMUL spec.
    The int8 cast wraps as the reference's does (an encoded 128 becomes
    -128)."""
    assert spec.lane_bits <= 8, "emulation lane limited to 8 bits (ops.py)"
    qw, scale = _quantize_per_tensor_sliced(w, spec.lane_bits)
    qw = emul_weight_transform(qw, spec)
    return PackedEmulWeight(emul_layout(qw.to(torch.int8)), scale)


def row_block(name: str, k_local: int, k_shards: int, block: int) -> int:
    """The AXQ block of a row-parallel shard of ``k_local`` rows out of
    ``k_local * k_shards``: resolved from the global K; raises, naming the
    leaf, when the shard is not a whole number of those blocks."""
    b = resolve_block(k_local * k_shards, block)
    if k_local % b:
        raise ValueError(
            f"{name}: the row-parallel shard of K {k_local} (global K "
            f"{k_local * k_shards} over tp={k_shards}) is not a whole number of AXQ "
            f"blocks ({b}); quantizing other blocks than one device's would change "
            "the arithmetic")
    return b


def pack_for_spec(w, spec, *, k_shards: int = 1, tp: int = 1, name: str = ""):
    """Pack one (..., K, N) weight for ``spec``; returns ``w`` unchanged for
    specs with no static operand encoding (EXACT / POW2_W) and for weights
    already packed.  ``k_shards`` > 1: ``w`` is a row-parallel shard (its
    block from the global K, :func:`row_block`); ``tp`` > 1: ``w`` is some
    shard of a mesh, which the *_EMUL packs refuse."""
    if is_packed(w):
        return w
    if spec.mode == ApproxMode.AXQ:
        return prepack_weight(w, row_block(name, w.shape[-2], k_shards, spec.block))
    if spec.mode in _EMUL_MODES:
        if tp > 1:
            raise NotImplementedError(
                f"{name}: {spec.mode.value} packs on a mesh (tp={tp}): a shard's "
                "per-tensor scale is not the whole tensor's")
        return prepack_emul_weight(w, spec)
    return w


def _pack_dense(p: dict, path: str, policy: ApproxPolicy, tp: int = 1) -> dict:
    """Pack one init_dense param dict ({"w": tensor[, "b": tensor]})."""
    k_shards = tp if is_row_parallel(path) else 1
    packed = pack_for_spec(p["w"], policy.spec_for(path), k_shards=k_shards, tp=tp,
                           name=f"{path}/w")
    if packed is p["w"]:
        return p
    return {**p, "w": packed}


def _pack_gated_mlp(p: dict, path: str, policy: ApproxPolicy, tp: int = 1) -> dict:
    return {k: _pack_dense(v, f"{path}/{k}", policy, tp) for k, v in p.items()}


def _pack_embed(p: dict, policy: ApproxPolicy, tp: int = 1) -> dict:
    """Tied unembedding: logits = x @ emb.T, so the K-major pack of
    ``emb.T`` quantizes ``emb`` itself.  The pack rides the embed dict as
    ``unembed_q``; the token-lookup ``emb`` stays float."""
    spec = policy.spec_for("unembed")
    if spec.mode == ApproxMode.EXACT or "unembed_q" in p:
        return p
    packed = pack_for_spec(p["emb"].transpose(-1, -2), spec, tp=tp, name="embed/emb")
    if not is_packed(packed):
        return p
    return {**p, "unembed_q": packed}


def _pack_transformer(params: dict, cfg, policy: ApproxPolicy, tp: int = 1) -> dict:
    out = dict(params)
    layers = dict(params["layers"])
    for key in ("wq", "wk", "wv", "wo"):
        layers[key] = _pack_dense(layers[key], f"layer/{key}", policy, tp)
    if "mlp" in layers:
        layers["mlp"] = _pack_gated_mlp(layers["mlp"], "layer/mlp", policy, tp)
    if "moe" in layers:
        from repro_torch.models.moe import expert_spec  # lazy: layering

        moe = dict(layers["moe"])
        # the apply-time expert spec (REPRO_MOE_INT8 included): pack iff
        # the experts will route AXQ
        espec = expert_spec(policy, "layer/moe")
        if espec.mode == ApproxMode.AXQ:
            moe["experts"] = {k: pack_for_spec(w, espec, tp=tp, name=f"layer/moe/experts/{k}")
                              for k, w in moe["experts"].items()}
        if "shared" in moe:
            moe["shared"] = {
                k: pack_for_spec(w, policy.spec_for(f"layer/moe/shared/{k}"),
                                 k_shards=tp if k == "down" else 1, tp=tp,
                                 name=f"layer/moe/shared/{k}")
                for k, w in moe["shared"].items()}
        layers["moe"] = moe
    out["layers"] = layers
    for fe, fcs in (("v_proj", ("fc1", "fc2")), ("a_proj", ("fc1",))):
        if fe in params:
            out[fe] = {k: _pack_dense(params[fe][k], f"{fe}/{k}", policy, tp) for k in fcs}
    if "unembed" in params:
        out["unembed"] = _pack_dense(params["unembed"], "unembed", policy, tp)
    elif cfg.tie_embeddings:
        out["embed"] = _pack_embed(params["embed"], policy, tp)
    return out


def _pack_ssm(params: dict, cfg, policy: ApproxPolicy, tp: int = 1) -> dict:
    out = dict(params)
    layers = dict(params["layers"])
    for key in ("in_proj", "out_proj"):
        layers[key] = _pack_dense(layers[key], f"layer/{key}", policy, tp)
    out["layers"] = layers
    out["embed"] = _pack_embed(params["embed"], policy, tp)
    return out


def _pack_rec_block(bp: dict, path: str, policy: ApproxPolicy, tp: int = 1) -> dict:
    out = dict(bp)
    for key in ("wx", "wg", "wa", "wi", "wo"):
        out[key] = _pack_dense(bp[key], f"{path}/{key}", policy, tp)
    out["mlp"] = _pack_gated_mlp(bp["mlp"], f"{path}/mlp", policy, tp)
    return out


def _pack_attn_block(bp: dict, path: str, policy: ApproxPolicy, tp: int = 1) -> dict:
    out = dict(bp)
    for key in ("wq", "wk", "wv", "wo"):
        out[key] = _pack_dense(bp[key], f"{path}/{key}", policy, tp)
    if "mlp" in bp:
        out["mlp"] = _pack_gated_mlp(bp["mlp"], f"{path}/mlp", policy, tp)
    return out


def _pack_hybrid(params: dict, cfg, policy: ApproxPolicy, tp: int = 1) -> dict:
    # packs resolve against the serve-time paths ("g/...", "tail/..."): the
    # ones prefill and decode dispatch through (models/rglru.py)
    out = dict(params)
    groups = dict(params["groups"])
    for gkey, gp in groups.items():
        pack = _pack_rec_block if gkey.startswith("rec") else _pack_attn_block
        groups[gkey] = pack(gp, "g", policy, tp)
    out["groups"] = groups
    out["tail"] = [_pack_rec_block(bp, "tail", policy, tp) for bp in params["tail"]]
    out["unembed"] = _pack_dense(params["unembed"], "unembed", policy, tp)
    return out


def prepack_params(params: dict, cfg, policy: ApproxPolicy, tp: int | None = None) -> dict:
    """Quantize-once pass over a model's param tree (dense, MoE, SSM,
    hybrid, or a frontend arch, its ``v_proj`` / ``a_proj`` projections
    included): every dense weight whose policy spec is AXQ becomes a
    :class:`PackedQWeight`, every one whose spec is *_EMUL a
    :class:`PackedEmulWeight` (per stacked-layer slice).
    Idempotent; EXACT-only policies return every tensor untouched.  The
    result is inference-only (int8 leaves carry no gradients).  ``tp``:
    the tensor-parallel degree the tree is a rank's shards of (default:
    the active mesh's ``model`` axis; module docstring)."""
    from repro_torch.dist import meshctx  # lazy: layering
    from repro_torch.models.transformer import check_supported, check_tp_supported

    check_supported(cfg)
    tp = meshctx.model_size() if tp is None else tp
    check_tp_supported(cfg, tp)
    if cfg.family == "ssm":
        return _pack_ssm(params, cfg, policy, tp)
    if cfg.family == "hybrid":
        return _pack_hybrid(params, cfg, policy, tp)
    return _pack_transformer(params, cfg, policy, tp)
