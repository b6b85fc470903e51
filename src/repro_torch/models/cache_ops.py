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
  * :func:`bit_flip` / :func:`cache_bit_flip` — the SEU injection
    primitives of ``repro_torch.resil.faults``: one bit of one element of
    any tensor, or of one slot's region of one cache field, in place.

The in-place forms keep every field at one device address, which a step
captured in a CUDA graph (``serve/graphs.py``) needs: a flip or a reset
written elsewhere would be invisible to the next replay.
"""

from __future__ import annotations

import numpy as np
import torch

#: the signed integer view a float of each width is flipped through
_FLOAT_BITS = {2: torch.int16, 4: torch.int32, 8: torch.int64}


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


def _signed_mask(bit: int, width: int) -> int:
    """``1 << bit`` as the signed value of a ``width``-bit lane (the top
    bit is the most negative value: bit 15 -> -32768, bit 7 -> -128)."""
    if not 0 <= bit < width:
        raise ValueError(f"bit {bit} outside a {width}-bit lane")
    return -(1 << bit) if bit == width - 1 else 1 << bit


def bit_flip(arr: torch.Tensor, index: int, bit: int) -> torch.Tensor:
    """Flip bit ``bit`` of the ``index``-th element of ``arr`` (row-major
    order of its logical shape, whatever its strides), in place; returns
    ``arr``.  Floats (f32/bf16/f16) flip through a signed integer view of
    the same width, so the operation is exact bit manipulation; integer
    tensors are flipped as they are.  No host read."""
    u = arr.view(_FLOAT_BITS[arr.element_size()]) if arr.is_floating_point() else arr
    pos = tuple(int(i) for i in np.unravel_index(int(index), tuple(arr.shape)))
    u[pos] ^= _signed_mask(int(bit), 8 * arr.element_size())
    return arr


def cache_bit_flip(cache, name: str, slot: int, index: int, bit: int):
    """SEU injection primitive: flip one bit at flat offset ``index`` inside
    slot ``slot``'s region (``field[:, slot]``) of cache field ``name``, in
    place.  ``length`` is refused — corrupting the slot cursor is a
    scheduler fault, not a memory upset.  Returns the cache."""
    if name == "length":
        raise ValueError("cache_bit_flip targets state regions, not length")
    bit_flip(getattr(cache, name)[:, slot], index, bit)
    return cache
