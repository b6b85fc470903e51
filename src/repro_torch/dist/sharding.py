"""Name-pattern partition rules (the port of ``repro.dist.sharding``,
DESIGN.md §5.2), and the slicing of a tree to one rank's local shards.

Megatron-style tensor parallelism over the ``"model"`` axis, resolved from
parameter *names* alone, with the reference's rule table:

  column-parallel  (output dim sharded, no forward collective): wq/wk/wv,
                   up, gate, in_proj, unembed, and any unrecognised ``w``
  row-parallel     (contracting dim sharded, output all-reduced): wo, down,
                   out_proj
  expert-parallel  (expert dim sharded): everything under ``experts/``
  vocab-parallel   the embedding table (a tied unembedding shards the
                   logits)
  replicated       norms, biases, routers, convs and every other small
                   parameter

A spec is a plain tuple, one entry a dim: an axis name, a tuple of axis
names (the batch dim over several data axes) or None.  Leading dims beyond
a rule's trailing pattern (the stacked-layer axis) stay unsharded: the
rules return trailing specs padded on the left with None to the leaf's
rank, as the reference's do.

:func:`shard_params` / :func:`shard_cache` cut a global tree down to this
rank's part: each sharded dim is split into equal contiguous pieces in
mesh-coordinate order (a dim that does not divide raises, naming the
leaf), so concatenating the ranks' pieces gives back the global leaf bit
for bit.  One rule goes beyond the spec table: the bias of a
column-parallel projection (a QKV bias) is sliced with its columns, where
the reference leaves it to the partitioner; a frontend's biases
(``v_proj``, ``a_proj``, whose weights are gathered whole before their
product) stay replicated.  Weights are sliced before
they are packed: the packs are built on each shard
(``kernels/qstore.py``, with the quantization block resolved from the
global contraction dim).

Training on a mesh shards a whole ``TrainState`` (:func:`shard_train_state`:
the parameters and AdamW's ``mu`` / ``nu`` by the same rules, the step
replicated), gathers a local tree back to its global leaves
(:func:`gather_params`, :func:`gather_train_state`: the checkpoint's
form), cuts a batch to this rank's rows (:func:`shard_batch`) and marks the
leaves split over ``model`` (:func:`model_sharded`: the gradient norm
counts a replicated leaf once).
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.dist import collectives
from repro_torch.dist.meshctx import Mesh, batch_axes, get_mesh
from repro_torch.tree import tree_leaves

#: module names whose dense ``w`` contracts over the sharded dim (output
#: reduction): the row-parallel projections
ROW_MODULES = ("wo", "down", "out_proj")
#: the paths that end in one of them (``is_row_parallel``)
ROW_PATHS = tuple(f"/{m}" for m in ROW_MODULES)
# leaf names that are projection matrices themselves (an MoE's shared
# experts store bare up/gate/down arrays)
_COL_LEAVES = {"up", "gate"}
_ROW_LEAVES = {"down"}
# modules that stay replicated although they hold a ``w``
_REPLICATED_MODULES = {"router", "conv"}
#: the frontends, whose column-parallel weights are gathered whole before
#: their product (``transformer.embed_inputs``): their biases stay
#: replicated, as the reference's rules leave every bias
_GATHERED_MODULES = ("v_proj", "a_proj")


def is_row_parallel(path: str) -> bool:
    """Whether the projection at ``path`` is a row-parallel shard on a
    mesh: packed with the global K's block (``kernels/qstore.py``), its
    partials reduced, or sent through the int8 ring (``kernels/ops.py``)."""
    return path.endswith(ROW_PATHS)


def spec_for_param(name: str, ndim: int) -> tuple:
    """The spec of a parameter with path ``name`` (/-joined) and rank
    ``ndim``.  Unknown names are replicated (the safe default)."""
    parts = name.lower().split("/")
    leaf = parts[-1] if parts else name
    module = parts[-2] if len(parts) >= 2 else ""
    trailing: tuple = ()
    if module in _REPLICATED_MODULES or leaf in _REPLICATED_MODULES:
        trailing = ()
    elif "experts" in parts:
        trailing = ("model", None, None)          # (E, d, f) / (E, f, d)
    elif leaf == "emb":
        trailing = ("model", None)                # (vocab, d) vocab-parallel
    elif leaf == "w" and module in ROW_MODULES or leaf in _ROW_LEAVES:
        trailing = ("model", None)                # (K_sharded, d)
    elif leaf == "w" or leaf in _COL_LEAVES:
        trailing = (None, "model")                # (d, N_sharded)
    if len(trailing) > ndim:
        trailing = ()
    return (None,) * (ndim - len(trailing)) + trailing


def _map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over the tensor leaves of a tree of dicts, lists
    and (Named)tuples, paths named as ``tree.named_leaves`` names them."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, join(k))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, join(i)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def _data_spec(mesh: Optional[Mesh]):
    """The batch dim's entry: None, one axis name, or a tuple of them (one
    name stands alone, as a ``PartitionSpec`` normalises it)."""
    b = batch_axes(mesh)
    if not b:
        return None
    return b[0] if len(b) == 1 else tuple(b)


def partition_params(params: Any, family: str = "") -> Any:
    """The spec tree of ``params`` (the tree's structure, a tuple a
    leaf).  ``family`` is accepted for per-family overrides, as the
    reference's is; the name rules cover every family."""
    del family
    return _map_with_path(lambda name, leaf: spec_for_param(name, leaf.dim()), params)


def partition_opt_state(opt: Any, pspecs: Any) -> Any:
    """AdamW state shards as the parameters do (``mu`` / ``nu`` mirror the
    parameter tree; the step counter is replicated)."""
    from repro_torch.optim.adamw import AdamWState

    return AdamWState(step=(), mu=pspecs, nu=pspecs)


def partition_batch(batch: Any, mesh: Optional[Mesh] = None) -> Any:
    """Batch leaves shard dim 0 over the data axes; the rest is replicated."""
    bd = _data_spec(mesh)

    def spec(_, leaf):
        nd = leaf.dim()
        return (bd,) + (None,) * (nd - 1) if nd else ()

    return _map_with_path(spec, batch)


def partition_cache(cache: Any, family: str = "", mesh: Optional[Mesh] = None) -> Any:
    """Decode-cache specs: KV stacks shard their heads over ``model`` and
    the slot batch over the data axes; recurrent states shard the batch
    (and the SSM's heads)."""
    del family
    bd = _data_spec(mesh)

    def spec(path, leaf):
        name = path.split("/")[-1] if path else ""
        nd = leaf.dim()
        if name == "length" or nd <= 1:
            return (bd,) if nd else ()
        if name in ("k", "v", "ks", "vs"):
            # (L, B, T, KVr[, D]): heads at dim 3
            return (None, bd, None, "model", None)[:nd]
        if name == "h" and nd == 5:
            return (None, bd, "model", None, None)   # SSM (L, B, H, P, N)
        return (None, bd) + (None,) * (nd - 2)       # (L, B, ...) states
    return _map_with_path(spec, cache)


def _axis_parts(entry, mesh: Mesh) -> tuple:
    """(number of pieces, this rank's piece) of one spec entry."""
    if entry is None:
        return 1, 0
    axes = entry if isinstance(entry, tuple) else (entry,)
    n, idx = 1, 0
    for a in axes:
        n, idx = n * mesh.size(a), idx * mesh.size(a) + mesh.coord(a)
    return n, idx


def shard_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh, name: str = "") -> torch.Tensor:
    """This rank's contiguous piece of ``x`` under ``spec`` (a copy, so the
    global tensor can be freed; ``x`` itself when nothing is sharded)."""
    if len(spec) != x.dim():
        raise ValueError(f"{name}: spec {spec} does not match a rank-{x.dim()} leaf")
    out = x
    for d, entry in enumerate(spec):
        n, idx = _axis_parts(entry, mesh)
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"{name}: dim {d} of size {x.shape[d]} does not split "
                             f"into {n} shards")
        step = x.shape[d] // n
        out = out.narrow(d, idx * step, step)
    return out if out is x else out.clone()


def _column_bias(p: dict, specs: dict) -> bool:
    w = specs.get("w")
    return (isinstance(p, dict) and "b" in p and isinstance(w, tuple) and bool(w)
            and w[-1] == "model")


def _leaf_specs(params: Any, specs: Any = None) -> Any:
    """The spec of every leaf as :func:`shard_params` cuts it: ``specs``
    (default :func:`partition_params`) with the bias of each
    column-parallel projection split with its columns.  Packed leaves
    raise: pack after sharding."""
    specs = partition_params(params) if specs is None else specs

    def walk(p, s, path):
        if isinstance(p, dict):
            out = {k: walk(v, s[k], f"{path}/{k}" if path else k) for k, v in p.items()}
            if _column_bias(p, s) and path.split("/")[0] not in _GATHERED_MODULES:
                out["b"] = (None,) * (p["b"].dim() - 1) + ("model",)
            return out
        if isinstance(p, tuple) and hasattr(p, "_fields"):
            raise ValueError(f"{path}: a packed weight ({type(p).__name__}) cannot be "
                             "sharded; shard the float tree, then pack")
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v, sv, f"{path}/{i}") for i, (v, sv) in enumerate(zip(p, s)))
        return None if p is None else s

    return walk(params, specs, "")


def _map_specs(fn, tree, specs, path: str = ""):
    """``fn(leaf, spec, path)`` over a tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v, specs[k], f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(_map_specs(fn, v, sv, f"{path}/{i}")
                          for i, (v, sv) in enumerate(zip(tree, specs)))
    return None if tree is None else fn(tree, specs, path)


def shard_params(params: Any, specs: Any = None, mesh: Optional[Mesh] = None) -> Any:
    """``params`` (a global float tree) cut to this rank's local shards by
    ``specs`` (default :func:`partition_params`), the bias of each
    column-parallel projection sliced with its columns.  Packed leaves
    cannot be sliced by these specs: pack after sharding."""
    mesh = mesh or get_mesh()
    return _map_specs(lambda x, s, path: shard_leaf(x, s, mesh, path), params,
                      _leaf_specs(params, specs))


def gather_leaf(x: torch.Tensor, spec: tuple, mesh: Mesh, name: str = "") -> torch.Tensor:
    """The global leaf of this rank's piece ``x`` under ``spec``: each dim
    split over a mesh axis all-gathered over that axis's group (the
    inverse of :func:`shard_leaf`; collective: every rank of the group
    calls it)."""
    out = x
    for d, entry in enumerate(spec):
        if _axis_parts(entry, mesh)[0] == 1:
            continue
        if isinstance(entry, tuple):
            raise NotImplementedError(f"{name}: gathering dim {d} over {entry}")
        out = collectives.all_gather(out, mesh.group(entry), dim=d)
    return out


def gather_params(local: Any, mesh: Optional[Mesh] = None) -> Any:
    """A tree of this rank's shards (:func:`shard_params`) gathered back to
    the global leaves (collective over ``model``)."""
    mesh = mesh or get_mesh()
    return _map_specs(lambda x, s, path: gather_leaf(x, s, mesh, path), local,
                      _leaf_specs(local))


def model_sharded(params: Any, mesh: Optional[Mesh] = None) -> list:
    """One bool a leaf, in ``tree_leaves`` order: whether the leaf is split
    over a mesh axis wider than 1 (False for every leaf on one device)."""
    mesh = mesh or get_mesh()
    specs = _map_specs(lambda x, s, path: any(_axis_parts(e, mesh)[0] > 1 for e in s),
                       params, _leaf_specs(params))
    return tree_leaves(specs)


def shard_train_state(state: Any, mesh: Optional[Mesh] = None) -> Any:
    """A global ``TrainState`` cut to this rank's part: the parameters by
    :func:`partition_params`, AdamW's ``mu`` / ``nu`` by
    :func:`partition_opt_state`, the step counters replicated."""
    mesh = mesh or get_mesh()
    pspecs = partition_params(state.params)
    ospecs = partition_opt_state(state.opt, pspecs)
    opt = state.opt
    return type(state)(shard_params(state.params, pspecs, mesh),
                       type(opt)(opt.step, shard_params(opt.mu, ospecs.mu, mesh),
                                 shard_params(opt.nu, ospecs.nu, mesh)),
                       state.step)


def gather_train_state(state: Any, mesh: Optional[Mesh] = None) -> Any:
    """The inverse of :func:`shard_train_state` (collective over
    ``model``)."""
    mesh = mesh or get_mesh()
    opt = state.opt
    return type(state)(gather_params(state.params, mesh),
                       type(opt)(opt.step, gather_params(opt.mu, mesh),
                                 gather_params(opt.nu, mesh)),
                       state.step)


def shard_batch(batch: dict, mesh: Optional[Mesh] = None) -> dict:
    """This rank's rows of a global batch (dim 0 split over the data axes
    by :func:`partition_batch`; a global batch that does not split
    raises)."""
    mesh = mesh or get_mesh()
    specs = partition_batch(batch, mesh)
    return {k: shard_leaf(v, specs[k], mesh, k) for k, v in batch.items()}


def shard_cache(cache: Any, specs: Any = None, mesh: Optional[Mesh] = None) -> Any:
    """A global cache cut to this rank's part by ``specs`` (default
    :func:`partition_cache`)."""
    mesh = mesh or get_mesh()
    specs = partition_cache(cache, mesh=mesh) if specs is None else specs
    return _map_with_path(
        lambda path, leaf: shard_leaf(leaf, _spec_at(specs, path), mesh, path), cache)


def _spec_at(specs, path: str):
    node = specs
    for k in path.split("/"):
        node = getattr(node, k) if hasattr(node, "_fields") else node[k]
    return node
