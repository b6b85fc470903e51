"""Token sampling for the fused serve step.

Greedy argmax, or temperature/top-k categorical sampling drawn from the
engine's ``torch.Generator`` (one per engine, seeded from its ``seed``), so
runs are reproducible from the engine seed.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

NEG_INF = -1e30


def sample_tokens(logits: Tensor, generator: torch.Generator | None, *,
                  greedy: bool, temperature: float = 1.0,
                  top_k: int = 0) -> Tensor:
    """logits: (B, V) -> (B,) int32 next tokens (ties: lowest index)."""
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    l = logits.to(torch.float32) / max(float(temperature), 1e-6)
    if top_k and top_k < l.shape[-1]:
        vals = torch.topk(l, top_k, dim=-1).values
        l = torch.where(l < vals[..., -1:], NEG_INF, l)
    probs = torch.softmax(l, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
