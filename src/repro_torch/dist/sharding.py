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
for bit.  Two rules go beyond the spec table, where the reference
leaves the data to the partitioner and the port computes on local
shards:

  * the bias of a column-parallel projection (a QKV bias) is sliced with
    its columns; a frontend's biases (``v_proj``, ``a_proj``, whose weights
    are gathered whole before their product) stay replicated;
  * the recurrent blocks are cut by heads and channels (:func:`_recurrent_cuts`).
    A Mamba-2 block's fused ``in_proj`` columns ``[z | x | B | C | dt]``
    are cut part by part (:class:`Parts`): rank r holds ``[z_r | x_r | B |
    C | dt_r]``, z, x and dt cut by heads, B and C whole; its conv
    channels ``[x_r | B | C]`` the same way; ``dt_bias``, ``a_log``, ``D``
    and ``gnorm`` the rank's heads and channels.  An RG-LRU block's conv
    and ``lam`` take the rank's channels.  Their caches follow
    (:func:`cache_leaf_specs`): the SSM's conv tail ``[x_r | B | C]``, the
    RG-LRU's state and conv tail the rank's channels.

Weights are sliced before
they are packed: the packs are built on each shard
(``kernels/qstore.py``, with the quantization block resolved from the
global contraction dim).

Training on a mesh shards a whole ``TrainState`` (:func:`shard_train_state`:
the parameters and AdamW's ``mu`` / ``nu`` by the same rules, the step
replicated), gathers a local tree back to its global leaves
(:func:`gather_params`, :func:`gather_train_state`: the checkpoint's
form), cuts a batch to this rank's rows (:func:`shard_batch`) and marks the
leaves split over ``model`` (:func:`model_sharded`; :func:`split_columns`
tells the gradient norm which entries are split, so a replicated leaf or
part counts once).
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class Parts:
    """The spec entry of a dim that is the concatenation of parts of
    ``widths`` (in the leaf's own terms: a global leaf's global widths, a
    rank's its local ones), each part flagged in ``split`` cut into equal
    contiguous pieces over ``model``, the others whole on every rank."""

    widths: tuple
    split: tuple


def _axis_parts(entry, mesh: Mesh) -> tuple:
    """(number of pieces, this rank's piece) of one spec entry."""
    if entry is None:
        return 1, 0
    if isinstance(entry, Parts):
        return mesh.size("model"), mesh.coord("model")
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
        if isinstance(entry, Parts):
            out = _cut_parts(out, d, entry, n, idx, name)
            continue
        if x.shape[d] % n:
            raise ValueError(f"{name}: dim {d} of size {x.shape[d]} does not split "
                             f"into {n} shards")
        step = x.shape[d] // n
        out = out.narrow(d, idx * step, step)
    return out if out is x else out.clone()


def _cut_parts(x: torch.Tensor, d: int, parts: Parts, n: int, idx: int,
               name: str) -> torch.Tensor:
    """Dim ``d`` of ``x`` cut part by part: piece ``idx`` of ``n`` of each
    split part, each other part whole, concatenated in order."""
    if sum(parts.widths) != x.shape[d]:
        raise ValueError(f"{name}: parts {parts.widths} do not make dim {d} of size "
                         f"{x.shape[d]}")
    pieces, off = [], 0
    for w, split in zip(parts.widths, parts.split):
        seg = x.narrow(d, off, w)
        off += w
        if split:
            if w % n:
                raise ValueError(f"{name}: a part of width {w} of dim {d} does not split "
                                 f"into {n} shards")
            seg = seg.narrow(d, idx * (w // n), w // n)
        pieces.append(seg)
    return torch.cat(pieces, dim=d)


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
            _recurrent_cuts(p, out)
            return out
        if isinstance(p, tuple) and hasattr(p, "_fields"):
            raise ValueError(f"{path}: a packed weight ({type(p).__name__}) cannot be "
                             "sharded; shard the float tree, then pack")
        if isinstance(p, (list, tuple)):
            return type(p)(walk(v, sv, f"{path}/{i}") for i, (v, sv) in enumerate(zip(p, s)))
        return None if p is None else s

    return walk(params, specs, "")


def _last(t: torch.Tensor, entry) -> tuple:
    """A spec that cuts the last dim of ``t`` by ``entry``."""
    return (None,) * (t.dim() - 1) + (entry,)


def _recurrent_cuts(p: dict, out: dict) -> None:
    """The recurrent blocks' cut by heads and channels (module docstring),
    set into ``out`` (the spec dict of ``p``).  A Mamba-2 block is the dict
    with ``in_proj``, ``conv``, ``dt_bias`` and ``gnorm``: its widths come
    from its own leaves (H from ``dt_bias``, d_in from ``gnorm``, N from
    what ``in_proj`` has left), so a global tree and a rank's local one each
    give their own.  An RG-LRU block is the dict with ``wx``, ``conv`` and
    ``lam``."""
    keys = p.keys()
    if {"in_proj", "conv", "dt_bias", "gnorm"} <= keys:
        H, d_in = p["dt_bias"].shape[-1], p["gnorm"]["scale"].shape[-1]
        w = p["in_proj"]["w"]
        N = (w.shape[-1] - 2 * d_in - H) // 2
        out["in_proj"]["w"] = _last(w, Parts((d_in, d_in, N, N, H),
                                             (True, True, False, False, True)))
        for k in ("w", "b"):
            out["conv"][k] = _last(p["conv"][k], Parts((d_in, 2 * N), (True, False)))
        for k in ("dt_bias", "a_log", "D"):
            out[k] = _last(p[k], "model")
        out["gnorm"]["scale"] = _last(p["gnorm"]["scale"], "model")
    elif {"wx", "conv", "lam"} <= keys:
        for k in ("w", "b"):
            out["conv"][k] = _last(p["conv"][k], "model")
        out["lam"] = _last(p["lam"], "model")


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
        n = _axis_parts(entry, mesh)[0]
        if n == 1:
            continue
        if isinstance(entry, tuple):
            raise NotImplementedError(f"{name}: gathering dim {d} over {entry}")
        if isinstance(entry, Parts):
            # every rank's piece in one gather, then each split part's n
            # pieces in order and each whole part once (rank 0's)
            ranks = collectives.all_gather(out, mesh.group("model"), dim=d).chunk(n, d)
            pieces, off = [], 0
            for w, split in zip(entry.widths, entry.split):
                pieces += [r.narrow(d, off, w) for r in (ranks if split else ranks[:1])]
                off += w
            out = torch.cat(pieces, dim=d)
            continue
        out = collectives.all_gather(out, mesh.group(entry), dim=d)
    return out


def gather_params(local: Any, mesh: Optional[Mesh] = None) -> Any:
    """A tree of this rank's shards (:func:`shard_params`) gathered back to
    the global leaves (collective over ``model``)."""
    mesh = mesh or get_mesh()
    return _map_specs(lambda x, s, path: gather_leaf(x, s, mesh, path), local,
                      _leaf_specs(local))


def model_sharded(params: Any, mesh: Optional[Mesh] = None) -> list:
    """One bool a leaf, in ``tree_leaves`` order: whether the leaf is split,
    whole or in part, over a mesh axis wider than 1 (False for every leaf
    on one device)."""
    mesh = mesh or get_mesh()
    specs = _map_specs(lambda x, s, path: any(_axis_parts(e, mesh)[0] > 1 for e in s),
                       params, _leaf_specs(params))
    return tree_leaves(specs)


@dataclasses.dataclass(frozen=True)
class ColumnSplit:
    """The last-dim columns of a leaf cut part by part: the indices of its
    split parts' columns and of the others (index tensors, not a boolean
    mask: selecting them depends on no data, so a meta run can too)."""

    split: torch.Tensor
    whole: torch.Tensor


def split_columns(params: Any, mesh: Optional[Mesh] = None) -> list:
    """One entry a leaf of a rank's local tree, in ``tree_leaves`` order:
    False for a leaf replicated over the mesh, True for a leaf split whole,
    and for a leaf cut part by part (:class:`Parts`, on its last dim) a
    :class:`ColumnSplit` of its last dim, made from the parts' widths (the
    gradient norm sums the split columns over ``model`` and counts the rest
    once)."""
    mesh = mesh or get_mesh()

    def entry(x, spec, path):
        last = spec[-1] if spec else None
        if isinstance(last, Parts) and _axis_parts(last, mesh)[0] > 1:
            cols: dict = {True: [], False: []}
            off = 0
            for w, s in zip(last.widths, last.split):
                cols[bool(s)].append(torch.arange(off, off + w, device=x.device))
                off += w
            return ColumnSplit(*(torch.cat(cols[s]) if cols[s] else
                                 torch.zeros((0,), dtype=torch.int64, device=x.device)
                                 for s in (True, False)))
        return any(_axis_parts(e, mesh)[0] > 1 for e in spec)

    return tree_leaves(_map_specs(entry, params, _leaf_specs(params)))


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


def cache_leaf_specs(cache: Any, mesh: Optional[Mesh] = None) -> Any:
    """The spec of every cache leaf as :func:`shard_cache` cuts it:
    :func:`partition_cache`'s, with the recurrent states cut by heads and
    channels (module docstring).  An SSM cache is the one whose ``h`` is
    (L, B, H, P, N): its conv tail's channels are ``[x | B | C]``, d_in = H
    P of them and N each of B and C.  A hybrid cache is the one whose ``h``
    is (n_rec, B, d): its state and conv tail are cut by channel."""
    specs = partition_cache(cache, mesh=mesh)
    if not (hasattr(cache, "_fields") and {"h", "conv"} <= set(cache._fields)):
        return specs
    h = cache.h
    if h.dim() == 5:
        conv = Parts((h.shape[2] * h.shape[3], 2 * h.shape[4]), (True, False))
        return specs._replace(conv=specs.conv[:-1] + (conv,))
    return specs._replace(h=specs.h[:-1] + ("model",), conv=specs.conv[:-1] + ("model",))


def shard_cache(cache: Any, specs: Any = None, mesh: Optional[Mesh] = None) -> Any:
    """A global cache cut to this rank's part by ``specs`` (default
    :func:`cache_leaf_specs`)."""
    mesh = mesh or get_mesh()
    specs = cache_leaf_specs(cache, mesh) if specs is None else specs
    return _map_with_path(
        lambda path, leaf: shard_leaf(leaf, _spec_at(specs, path), mesh, path), cache)


def gather_cache(local: Any, mesh: Optional[Mesh] = None) -> Any:
    """The inverse of :func:`shard_cache` (collective over ``model``)."""
    mesh = mesh or get_mesh()
    specs = cache_leaf_specs(local, mesh)
    return _map_with_path(
        lambda path, leaf: gather_leaf(leaf, _spec_at(specs, path), mesh, path), local)


def _spec_at(specs, path: str):
    node = specs
    for k in path.split("/"):
        node = getattr(node, k) if hasattr(node, "_fields") else node[k]
    return node
