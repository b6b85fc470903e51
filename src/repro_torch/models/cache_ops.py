"""Slot-lifecycle primitives over decode caches (serving subsystem).

Caches are NamedTuples with one layout convention: ``length`` (B,) has the
slot dim at axis 0; every other field carries a leading stack axis (layers)
with the slot dim at axis 1.

  * :func:`cache_reset_slot` — rewind one slot's region to the init state,
    so a reused slot is indistinguishable from a fresh one.  In place.
  * :func:`cache_mask_update` — freeze free slots' ``length`` at its
    pre-step value, masking them out of the fused decode step.
  * :func:`ring_write_indices` — the index plan of a prompt's cache write.
"""

from __future__ import annotations

import torch


def cache_reset_slot(cache, slot):
    """Zero slot ``slot``'s region in every field and rewind its length, in
    place (``slot``: int or 0-d tensor).  Returns the cache."""
    for name in cache._fields:
        o = getattr(cache, name)
        if name == "length":
            o[slot] = 0
        else:
            o[:, slot] = 0
    return cache


def cache_mask_update(old_cache, new_cache, active):
    """Slots where ``active`` (bool (B,)) is False keep their pre-step
    ``length``: a pinned length pins both the slot's write position and its
    valid-range read mask, so the region never advances."""
    length = torch.where(active, new_cache.length, old_cache.length)
    return new_cache._replace(length=length)


def ring_write_indices(prompt_len: int, capacity: int, device="cpu"):
    """Index plan for writing a ``prompt_len`` prefix into a cache ring of
    ``capacity`` positions: the last ``n = min(P, T)`` tokens, mapped to
    ring positions ``src % T``.  Returns (src (n,), dst (n,))."""
    n = min(prompt_len, capacity)
    src = torch.arange(prompt_len - n, prompt_len, dtype=torch.int64, device=device)
    return src, torch.remainder(src, capacity)
