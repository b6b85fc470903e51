"""Walks over the port's parameter and state trees: nested dicts, lists and
tuples of tensors (NamedTuples keep their type), in the reference's
``jax.tree_util`` order and naming — dict keys sorted, NamedTuple fields
and list items in order, None contributing nothing."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The leaves in ``jax.tree_util.tree_flatten`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]


def named_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) pairs in that order, named as
    ``jax.tree_util.tree_flatten_with_path`` paths are joined by the
    reference's checkpointer: dict keys, NamedTuple field names and list
    indices between slashes (``params/layers/wq/w``)."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in named_leaves(tree[k], join(k))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for k, v in zip(tree._fields, tree) for kv in named_leaves(v, join(k))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in named_leaves(v, join(i))]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    if t is None:
        return None
    return fn(*trees)


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            got = {k: build(t[k]) for k in sorted(t)}
            return {k: got[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        if t is None:
            return None
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
