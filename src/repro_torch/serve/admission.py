"""Admission pipeline configuration (a copy of ``repro.serve.admission``).

The production admission shape (MaxText ``offline_inference.py``): prompts
are prefills at one of a fixed ladder of power-of-two *bucket* lengths, so
the set of prefill call shapes is closed and a warmup pass can run each of
them before the first request.  Short prompts *pack* — up to ``pack`` rows
ride one bucketed prefill call, each row writing into its own slot (dummy
rows carry an out-of-range slot and write nothing).  Long prompts *chunk*
— split into ``chunk_tokens``-sized pieces admitted across ticks,
interleaved with decode, so a long arrival cannot stall short-request TTFT.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


def bucket_ladder(max_len: int, min_bucket: int = 16) -> Tuple[int, ...]:
    """Power-of-two prefill lengths from ``min_bucket`` up to the smallest
    power of two covering ``max_len - 1`` (the prefix of a full-length
    prompt; the final token rides the decode feed).  The last rung is
    capped at ``max_len`` so a non-power-of-two cache capacity never gets
    a bucket its dense cache cannot hold."""
    if max_len < 2:
        return (min(min_bucket, max(max_len, 1)),)
    buckets = []
    b = min_bucket
    while b < max_len - 1:
        buckets.append(b)
        b *= 2
    buckets.append(min(b, max_len))
    return tuple(buckets)


def bucket_for(n: int, buckets: Tuple[int, ...]) -> int:
    """Smallest bucket >= n; raises when the ladder cannot hold n."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"prompt prefix ({n}) exceeds largest bucket "
                     f"({buckets[-1]})")


@dataclass(frozen=True)
class AdmissionConfig:
    """Knobs for the bucketed/packed/chunked admission pipeline.

    buckets: ascending prefill lengths; () derives a power-of-two ladder
        from the engine's ``max_len`` at construction.
    pack: rows per bucketed prefill call (1 = no packing).  Calls are always
        padded to exactly ``pack`` rows so each bucket has ONE call shape.
    chunk_tokens: split prompts longer than this into chunks admitted across
        ticks (0 = disabled).  Only dense full-attention transformer caches
        chunk; other families fall back to whole-prompt bucketed prefill.
    chunk_calls_per_tick: admission-vs-decode interleave ratio — chunk calls
        issued per engine tick for a mid-admission slot.
    warmup: run every bucket/chunk/step call shape at construction.
    """

    buckets: Tuple[int, ...] = ()
    pack: int = 1
    chunk_tokens: int = 0
    chunk_calls_per_tick: int = 1
    warmup: bool = True

    def __post_init__(self):
        if self.pack < 1:
            raise ValueError("pack must be >= 1")
        if self.chunk_tokens < 0:
            raise ValueError("chunk_tokens must be >= 0")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError("buckets must be strictly ascending")

    def resolved(self, max_len: int) -> "AdmissionConfig":
        """Fill the default bucket ladder from the engine's max_len."""
        if self.buckets:
            return self
        return AdmissionConfig(buckets=bucket_ladder(max_len),
                               pack=self.pack,
                               chunk_tokens=self.chunk_tokens,
                               chunk_calls_per_tick=self.chunk_calls_per_tick,
                               warmup=self.warmup)
