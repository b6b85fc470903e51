"""Convert the reference package's parameter trees and caches, given as
numpy arrays, into the port's tensors.

The reference keeps parameters as nested dicts whose leaves are arrays or
NamedTuples of arrays (packed weights: fields ``qw``/``scales`` for AXQ,
``qw``/``scale`` for the *_EMUL modes) and caches
as NamedTuples with fields ``k``/``v``/``length`` (the int8 cache also
``ks``/``vs``).  These walkers recognise
them by duck typing — this module imports neither JAX nor the reference
package.  A training state (fields ``params``, ``opt`` with ``step``/``mu``/
``nu``, and ``step``) goes both ways: :func:`train_state_from_numpy`
(this rank's shards of it on a mesh), :func:`train_state_to_numpy`.  An MoE tree comes across the same way: the router, the experts
with leading (n_layers, n_experts) axes (packed per slice, or float), the
shared experts, and each one's packs; a hybrid tree with its ``tail`` list of
recurrent blocks.  The caller does the array-to-numpy step (for example
``jax.tree.map(np.asarray, tree)``).  A float tree built by the reference
with ``model.init(key, tp=tp)`` becomes one rank's local shards through
:func:`shard_from_numpy` (``params_from_numpy``, then
``dist.sharding.shard_params``: the recurrent blocks cut by heads and
channels, a Mamba-2 ``in_proj`` part by part); the packs are built on the
shards afterwards.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.qstore import PackedEmulWeight, PackedQWeight, emul_layout
from repro_torch.models.rglru import HybridCache
from repro_torch.models.ssm import SSMCache
from repro_torch.models.transformer import LMCache, LMCacheQ


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """One array -> tensor (copying), bfloat16 arrays included."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts / lists of arrays, with packed weights as objects with
    ``qw`` and ``scales`` (AXQ) or ``qw`` and ``scale`` (*_EMUL) -> the same
    tree of tensors, packed weights as
    :class:`~repro_torch.kernels.qstore.PackedQWeight` /
    :class:`~repro_torch.kernels.qstore.PackedEmulWeight` (its ``qw`` in
    the column-major layout the card's integer product takes)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if hasattr(tree, "qw") and hasattr(tree, "scales"):
        return PackedQWeight(tensor_from_numpy(tree.qw, device),
                             tensor_from_numpy(tree.scales, device))
    if hasattr(tree, "qw") and hasattr(tree, "scale"):
        return PackedEmulWeight(emul_layout(tensor_from_numpy(tree.qw, device)),
                                tensor_from_numpy(tree.scale, device))
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(tree, device)


def cache_from_numpy(cache, device="cpu"):
    """A cache with fields ``k``/``v``/``length`` (arrays) -> :class:`LMCache`;
    one that also has ``ks``/``vs`` (the int8 cache) -> :class:`LMCacheQ`;
    ``h``/``conv``/``length`` (the SSM's) -> ``SSMCache``; and with ``k``/``v``
    besides (the hybrid's) -> ``HybridCache``."""
    t = lambda a: tensor_from_numpy(a, device)
    length = t(cache.length).to(torch.int32)
    if hasattr(cache, "h") and hasattr(cache, "conv"):
        if hasattr(cache, "k"):
            return HybridCache(t(cache.k), t(cache.v), t(cache.h), t(cache.conv), length)
        return SSMCache(t(cache.h), t(cache.conv), length)
    if hasattr(cache, "ks") and hasattr(cache, "vs"):
        return LMCacheQ(t(cache.k), t(cache.v), t(cache.ks), t(cache.vs), length)
    return LMCache(t(cache.k), t(cache.v), length)


def train_state_from_numpy(state, device="cpu", mesh=None):
    """A training state with fields ``params``, ``opt`` (``step``, ``mu``,
    ``nu``) and ``step``, given as arrays -> the port's
    :class:`~repro_torch.train.step.TrainState` of tensors; with ``mesh``
    (a :class:`~repro_torch.dist.meshctx.Mesh`) this rank's shards of it
    (``dist.sharding.shard_train_state``; the global state as the
    reference's ``init_state(model, key, tp)`` builds it)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.train.step import TrainState

    t = lambda tree: params_from_numpy(tree, device)
    out = TrainState(t(state.params),
                     AdamWState(tensor_from_numpy(state.opt.step, device), t(state.opt.mu),
                                t(state.opt.nu)),
                     tensor_from_numpy(state.step, device))
    if mesh is None:
        return out
    from repro_torch.dist.sharding import shard_train_state

    return shard_train_state(out, mesh)


def train_state_to_numpy(state):
    """The port's TrainState -> the same NamedTuples holding numpy arrays
    (f32 and int32 leaves; the reference's ``TrainState(*tree)`` takes the
    fields in this order)."""
    from repro_torch.tree import tree_map

    return tree_map(lambda x: x.detach().cpu().numpy(), state)


def shard_from_numpy(tree, mesh=None, device="cpu"):
    """This rank's local shards of a global float parameter tree given as
    numpy arrays (the reference's ``model.init(key, tp=tp)`` for the
    mesh's ``model`` axis ``tp``): :func:`params_from_numpy`, then
    :func:`~repro_torch.dist.sharding.shard_params` on ``mesh`` (default:
    the active one)."""
    from repro_torch.dist.sharding import shard_params

    return shard_params(params_from_numpy(tree, device), mesh=mesh)
