"""Minimal pytree helpers over the port's containers.

The reference relies on ``jax.tree``; the port's values are dicts of
tensors (deformations), NamedTuples (``RegElement``), lists and tuples.
These helpers map over exactly those containers and treat everything else
(tensors, numbers) as a leaf.  :func:`tree_flatten` / :func:`tree_unflatten`
order dict entries by sorted key, as ``jax.tree.flatten`` does, so packed
layouts (``kernels/_tiling.py``) match the reference column for column.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over ``tree`` and structurally equal ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest]) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[
            tree_map(fn, t, *[r[i] for r in rest]) for i, t in enumerate(tree)
        ])
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map(fn, t, *[r[i] for r in rest]) for i, t in enumerate(tree)
        )
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves of ``tree`` in container order (dict insertion order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tensor_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of ``tree`` (index pairs and other scalars dropped)."""
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def tree_stack(trees: List[Any]) -> Any:
    """Stack structurally equal trees of tensors along a new leading axis."""
    return tree_map(lambda *ts: torch.stack(ts, dim=0), *trees)


def tree_index(tree: Any, i) -> Any:
    """Index every leaf of ``tree`` along its leading axis."""
    return tree_map(lambda t: t[i], tree)


def tree_flatten(tree: Any) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)`` with dict entries in sorted-key order (the
    order ``jax.tree.flatten`` uses).  ``treedef`` is a hashable nested
    tuple; equal structures give equal treedefs."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [tree_flatten(tree[k]) for k in keys]
        return ([leaf for ls, _ in parts for leaf in ls],
                ("dict", tuple(keys), tuple(d for _, d in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [tree_flatten(t) for t in tree]
        return ([leaf for ls, _ in parts for leaf in ls],
                (type(tree), None, tuple(d for _, d in parts)))
    return [tree], None


def tree_unflatten(treedef: Any, leaves: List[Any]) -> Any:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(td):
        if td is None:
            return next(it)
        kind, keys, children = td
        vals = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(keys, vals))
        if hasattr(kind, "_fields"):
            return kind(*vals)
        return kind(vals)

    return build(treedef)
