"""Model API over the ported families: dense, MoE, SSM (Mamba-2), hybrid
(RG-LRU + local attention), VLM and audio (the transformer with its
frontend stub), dispatched by ``cfg.family``.

    model = build_model(cfg, policy)               # device="cuda" by default
    params = model.init(seed=0)
    loss, metrics = model.loss(params, batch, remat="none")   # training
    cache = model.init_cache(tp, batch, max_len)   # int8 with REPRO_KV_INT8=1
    logits, cache = model.prefill(params, cache, tokens, slot)
    cache = model.prefill_batch(params, cache, tokens, slots, lengths)
    cache = model.prefill_chunk(params, cache, tokens, slot, offset, clen)
    logits, cache = model.decode_step(params, cache, tokens)

Every compute entry point takes a runtime ``degree``: None, a global
scalar, or an ``(n_layers + 1,)`` per-site vector (models/degrees.py).  The
SSM and hybrid families keep a cache of per-slot state (their recurrent
state and conv tails, the hybrid also its attention rings), whatever
``quant`` or ``REPRO_KV_INT8`` say: neither has an int8 cache.  The VLM
serves text-only prompts (its prefill and decode embed tokens alone, as the
reference's do); the audio arch is encoder-only and has no cache.  On a
mesh (``dist/meshctx.py``) every entry point takes a rank's shards, its
rows of a training batch and its part of the cache, in every family (the
audio arch trains there and, having no decode step, does not serve).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.approx import ApproxPolicy
from repro_torch.device import resolve_device
from repro_torch.dist import meshctx
from repro_torch.models import rglru, ssm, transformer


@dataclass
class Model:
    """One arch under one policy on one device: the card unless the caller
    asks for ``device="cpu"`` (with no card, the default raises)."""

    cfg: ArchConfig
    policy: ApproxPolicy = field(default_factory=ApproxPolicy)
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init(self, seed: int = 0, tp: int = 1,
             generator: Optional[torch.Generator] = None):
        """Random-init parameters on the model's device from ``generator``
        (or a fresh one seeded with ``seed``)."""
        gen = generator
        if gen is None:
            # the meta device draws nothing: a host generator stands in
            where = "cpu" if self.device.type == "meta" else self.device
            gen = torch.Generator(device=where).manual_seed(seed)
        if self.cfg.family == "hybrid":
            return rglru.init_hybrid(gen, self.cfg, tp, self.device)
        if self.cfg.family == "ssm":
            return ssm.init_ssm_lm(gen, self.cfg, tp, self.device)
        return transformer.init_lm(gen, self.cfg, tp, self.device)

    def _forward_fn(self):
        return {"hybrid": rglru.hybrid_forward,
                "ssm": ssm.ssm_forward}.get(self.cfg.family, transformer.lm_forward)

    def forward(self, params, batch, tp: int = 1, degree=None, remat="dots"):
        """(logits f32, aux loss); ``remat`` is the layers' activation
        policy under autograd (``transformer.remat_call``).  On a mesh of
        more than one rank (training): this rank's shards, rows and vocab
        columns."""
        return self._forward_fn()(params, self.cfg, self.policy, batch, tp, degree, remat)

    def loss(self, params, batch, tp: int = 1, degree=None, remat="dots"):
        """(loss, {"ce", "aux", "ntokens"}): the masked cross-entropy over
        ``labels >= 0``; the dense and MoE families add 0.01 x the aux
        load-balance loss, the SSM and hybrid families have none.  On a
        mesh the loss is this rank's share (``transformer.lm_loss``)."""
        return transformer.lm_loss(params, self.cfg, self.policy, batch, tp, degree, remat,
                                   forward=self._forward_fn())

    def init_cache(self, tp: int, batch: int, max_len: int,
                   dtype=torch.bfloat16, quant: Optional[bool] = None):
        """The decode cache: for the SSM and hybrid families their state
        cache; else int8 (:class:`~repro_torch.models.transformer.LMCacheQ`)
        when ``quant``, or when ``quant`` is None and ``REPRO_KV_INT8=1``.
        An encoder-only arch (the audio family) has no decode step: it
        raises, as the reference does."""
        transformer.check_tp_supported(self.cfg, meshctx.model_size())
        if self.cfg.encoder_only:
            raise ValueError("encoder-only arch has no decode step")
        if self.cfg.family == "hybrid":
            return rglru.init_hybrid_cache(self.cfg, tp, batch, max_len, dtype, self.device)
        if self.cfg.family == "ssm":
            return ssm.init_ssm_cache(self.cfg, tp, batch, max_len, dtype, self.device)
        if quant is None:
            quant = os.environ.get("REPRO_KV_INT8", "0") == "1"
        return transformer.init_lm_cache(self.cfg, tp, batch, max_len, dtype,
                                         self.device, quant=quant)

    def decode_step(self, params, cache, tokens, tp: int = 1, degree=None,
                    active=None):
        """``active`` (B,) bool: the attention kernel's free-slot mask (the
        SSM has no attention and ignores it)."""
        transformer.check_tp_supported(self.cfg, meshctx.model_size())
        if self.cfg.family == "hybrid":
            return rglru.hybrid_decode_step(params, self.cfg, self.policy, cache, tokens,
                                            tp, degree, active)
        if self.cfg.family == "ssm":
            return ssm.ssm_decode_step(params, self.cfg, self.policy, cache, tokens, tp,
                                       degree)
        return transformer.lm_decode_step(params, self.cfg, self.policy,
                                          cache, tokens, tp, degree, active)

    def prefill(self, params, cache, tokens, slot, tp: int = 1, degree=None):
        """Fused prefill of prompt ``tokens`` (P,) into ``slot``'s region.
        Returns (last-position logits (1, V) f32, cache)."""
        transformer.check_tp_supported(self.cfg, meshctx.model_size())
        if self.cfg.family == "hybrid":
            return rglru.hybrid_prefill(params, self.cfg, self.policy, cache, tokens, slot,
                                        tp, degree)
        if self.cfg.family == "ssm":
            return ssm.ssm_prefill(params, self.cfg, self.policy, cache, tokens, slot, tp,
                                   degree)
        return transformer.lm_prefill(params, self.cfg, self.policy,
                                      cache, tokens, slot, tp, degree)

    def prefill_batch(self, params, cache, tokens, slots, lengths,
                      tp: int = 1, degree=None):
        """Bucketed/packed prefill: ``tokens`` (N, Pb) rows padded to one
        bucket length, written into ``slots`` (N,) with true ``lengths``
        (N,) — host integers; a row with ``slot >= B`` is a dummy and writes
        nothing.  Per row equal to :meth:`prefill` at the exact length.
        Returns the cache.  MoE raises: capacity routing couples the rows of
        one call, so MoE admits at the exact length."""
        if self.cfg.family == "hybrid":
            return rglru.hybrid_prefill_batch(params, self.cfg, self.policy, cache, tokens,
                                              slots, lengths, tp, degree)
        if self.cfg.family == "ssm":
            return ssm.ssm_prefill_batch(params, self.cfg, self.policy, cache, tokens,
                                         slots, lengths, tp, degree)
        return transformer.lm_prefill_batch(params, self.cfg, self.policy, cache,
                                            tokens, slots, lengths, tp, degree)

    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill serves dense full-attention transformers (no MoE,
        no sliding window, no frontend)."""
        c = self.cfg
        return (c.family not in ("hybrid", "ssm") and not c.moe
                and c.swa_window is None and c.causal and c.frontend is None)

    def prefill_chunk(self, params, cache, tokens, slot: int, offset: int,
                      clen: int, tp: int = 1, degree=None):
        """Incremental prefill of one chunk (``tokens`` (C,), ``clen`` real)
        at position ``offset`` of ``slot``'s prompt; bf16/f32 caches of the
        archs :meth:`supports_chunked_prefill` admits.  Returns the cache."""
        if not self.supports_chunked_prefill():
            raise ValueError(f"chunked prefill unsupported for {self.cfg.name}")
        if isinstance(cache, transformer.LMCacheQ):
            raise ValueError("chunked prefill serves the bf16/f32 cache only")
        return transformer.lm_prefill_chunk(params, self.cfg, self.policy, cache,
                                            tokens, slot, offset, clen, tp, degree)

    def reset_slot(self, cache, slot):
        from repro_torch.models.cache_ops import cache_reset_slot

        return cache_reset_slot(cache, slot)

    def prepack(self, params):
        """Quantize-once weight residency: every AXQ dense weight becomes a
        PackedQWeight (the hybrid's against its serve-time paths ``g/...``
        and ``tail/...``).  Idempotent; inference-only."""
        from repro_torch.kernels import qstore

        return qstore.prepack_params(params, self.cfg, self.policy)


def build_model(cfg: ArchConfig, policy: Optional[ApproxPolicy] = None,
                device="cuda") -> Model:
    """A :class:`Model` on ``device`` (the card by default; raises without
    one unless ``device="cpu"``)."""
    transformer.check_supported(cfg)
    return Model(cfg, policy or ApproxPolicy(), device)


# ---------------------------------------------------------------------------
# input specs — shape-only stand-ins for every model input
# ---------------------------------------------------------------------------


def input_specs(cfg: ArchConfig, shape_name: str) -> dict:
    """The input batch of (arch, shape) as ``meta`` tensors: shapes and
    dtypes with no storage (the reference's ShapeDtypeStructs)."""
    from repro_torch.configs.base import SHAPES

    s = SHAPES[shape_name]
    B, S = s.global_batch, s.seq_len
    sd = lambda *shape, dtype=torch.int32: torch.empty(shape, dtype=dtype, device="meta")
    if s.kind == "decode":
        return {"tokens": sd(B, 1)}
    if cfg.frontend == "vision":
        s_img = cfg.frontend_tokens
        return {"tokens": sd(B, S - s_img),
                "patch_embeds": sd(B, s_img, cfg.frontend_dim, dtype=torch.float32),
                "labels": sd(B, S - s_img)}
    if cfg.frontend == "audio":
        return {"frame_feats": sd(B, S, cfg.frontend_dim, dtype=torch.float32),
                "labels": sd(B, S)}
    return {"tokens": sd(B, S), "labels": sd(B, S)}


def concrete_batch(cfg: ArchConfig, seq: int, batch: int,
                   generator: Optional[torch.Generator] = None, device="cpu") -> dict:
    """A small random batch (tokens and labels uniform over the vocab, int64,
    and the frontends' float features) on ``device``, drawn from
    ``generator`` (or one seeded with 0 on ``device``)."""
    dev = torch.device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(0)
    ints = lambda *shape: torch.randint(0, cfg.vocab, shape, generator=gen, device=dev)
    normal = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    if cfg.frontend == "audio":
        return {"frame_feats": normal(batch, seq, cfg.frontend_dim),
                "labels": ints(batch, seq)}
    if cfg.frontend == "vision":
        s_txt = seq - cfg.frontend_tokens
        return {"patch_embeds": normal(batch, cfg.frontend_tokens, cfg.frontend_dim),
                "tokens": ints(batch, s_txt), "labels": ints(batch, s_txt)}
    return {"tokens": ints(batch, seq), "labels": ints(batch, seq)}
