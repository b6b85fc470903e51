"""Slot-lifecycle primitives over decode caches (serving subsystem).

Caches are NamedTuples with one layout convention: ``length`` (B,) has the
slot dim at axis 0; every other field carries a leading stack axis (layers)
with the slot dim at axis 1.

  * :func:`cache_reset_slot` — rewind one slot's region to the init state,
    so a reused slot is indistinguishable from a fresh one.  In place; a
    device slot index with a mask rewinds without a host read.
  * :func:`cache_mask_update` — freeze free slots' ``length`` at its
    pre-step value, masking them out of the fused decode step; written in
    place into a given state's ``length``.
  * :func:`ring_write_indices` — the index plan of a prompt's cache write.

The in-place forms keep every field at one device address, which a step
captured in a CUDA graph (``serve/graphs.py``) needs.
"""

from __future__ import annotations

import torch


def cache_reset_slot(cache, slot, mask=None):
    """Zero slot ``slot``'s region in every field and rewind its length, in
    place.  ``slot``: an int or a 0-d tensor; or, with ``mask``, a device
    index tensor (0-d or (n,), every entry in range) whose entries reset
    only where ``mask`` (bool, same shape) holds — the others write their
    old values back, so nothing is read on the host.  Returns the cache."""
    if mask is None:
        for name in cache._fields:
            o = getattr(cache, name)
            if name == "length":
                o[slot] = 0
            else:
                o[:, slot] = 0
        return cache
    idx = slot.reshape(-1)
    keep = ~mask.reshape(-1)
    for name in cache._fields:
        o = getattr(cache, name)
        axis = 0 if name == "length" else 1
        old = o.index_select(axis, idx)
        shape = [1] * o.dim()
        shape[axis] = -1
        o.index_copy_(axis, idx, torch.where(keep.reshape(shape), old, torch.zeros_like(old)))
    return cache


def cache_mask_update(old_cache, new_cache, active, into=None):
    """Slots where ``active`` (bool (B,)) is False keep their pre-step
    ``length``: a pinned length pins both the slot's write position and its
    valid-range read mask, so the region never advances.  The masked
    length is written in place into ``into.length`` (default
    ``new_cache.length``); returns ``new_cache`` carrying that tensor."""
    dst = (new_cache if into is None else into).length
    dst.copy_(torch.where(active, new_cache.length, old_cache.length))
    return new_cache._replace(length=dst)


def ring_write_indices(prompt_len: int, capacity: int, device="cpu"):
    """Index plan for writing a ``prompt_len`` prefix into a cache ring of
    ``capacity`` positions: the last ``n = min(P, T)`` tokens, mapped to
    ring positions ``src % T``.  Returns (src (n,), dst (n,))."""
    n = min(prompt_len, capacity)
    src = torch.arange(prompt_len - n, prompt_len, dtype=torch.int64, device=device)
    return src, torch.remainder(src, capacity)
