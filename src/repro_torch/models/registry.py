"""Model API over the ported families (dense so far).

    model = build_model(cfg, policy)               # device="cuda" by default
    params = model.init(seed=0)
    cache = model.init_cache(tp, batch, max_len)
    logits, cache = model.prefill(params, cache, tokens, slot)
    logits, cache = model.decode_step(params, cache, tokens)

Every compute entry point takes a runtime ``degree``: None, a global
scalar, or an ``(n_layers + 1,)`` per-site vector (models/degrees.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.approx import ApproxPolicy
from repro_torch.device import resolve_device
from repro_torch.models import transformer


@dataclass
class Model:
    cfg: ArchConfig
    policy: ApproxPolicy = field(default_factory=ApproxPolicy)
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))

    def init(self, seed: int = 0, tp: int = 1,
             generator: Optional[torch.Generator] = None):
        """Random-init parameters on the model's device from ``generator``
        (or a fresh one seeded with ``seed``)."""
        gen = generator
        if gen is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        return transformer.init_lm(gen, self.cfg, tp, self.device)

    def forward(self, params, batch, tp: int = 1, degree=None):
        return transformer.lm_forward(params, self.cfg, self.policy, batch,
                                      tp, degree)

    def init_cache(self, tp: int, batch: int, max_len: int,
                   dtype=torch.bfloat16):
        return transformer.init_lm_cache(self.cfg, tp, batch, max_len, dtype,
                                         self.device)

    def decode_step(self, params, cache, tokens, tp: int = 1, degree=None,
                    active=None):
        return transformer.lm_decode_step(params, self.cfg, self.policy,
                                          cache, tokens, tp, degree, active)

    def prefill(self, params, cache, tokens, slot, tp: int = 1, degree=None):
        """Fused prefill of prompt ``tokens`` (P,) into ``slot``'s region.
        Returns (last-position logits (1, V) f32, cache)."""
        return transformer.lm_prefill(params, self.cfg, self.policy,
                                      cache, tokens, slot, tp, degree)

    def reset_slot(self, cache, slot):
        from repro_torch.models.cache_ops import cache_reset_slot

        return cache_reset_slot(cache, slot)

    def prepack(self, params):
        """Quantize-once weight residency: every AXQ dense weight becomes a
        PackedQWeight.  Idempotent; inference-only."""
        from repro_torch.kernels import qstore

        return qstore.prepack_params(params, self.cfg, self.policy)


def build_model(cfg: ArchConfig, policy: Optional[ApproxPolicy] = None,
                device="cuda") -> Model:
    """A :class:`Model` on ``device`` (the card by default; raises without
    one unless ``device="cpu"``)."""
    transformer.check_supported(cfg)
    return Model(cfg, policy or ApproxPolicy(), resolve_device(device))
