"""Nested containers of tensors (the port's pytrees).

Parameters, optimizer state and checkpoints are plain nested dicts, lists
and tuples with tensors (or arrays, numbers) at the leaves, as the JAX
package's pytrees are. Leaves are visited in `jax.tree_util`'s order:
dict keys sorted, list and tuple items by index; None holds no leaf. A
leaf's name joins its path's keys and indices with "//", as
`repro.checkpoint.ckpt` names them, so checkpoints name the same leaves in
both packages.
"""

from __future__ import annotations

from typing import Any, Callable

SEP = "//"


def _children(tree) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of a container, in visiting order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def flatten_with_names(tree, is_leaf: Callable[[Any], bool] | None = None
                       ) -> tuple[list[str], list[Any]]:
    """(names, leaves) in visiting order; `is_leaf(node)` true stops the
    walk at a container, which is then one leaf (as jax.tree_util's)."""
    names, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        kids = None if is_leaf is not None and is_leaf(node) \
            else _children(node)
        if kids is None:
            names.append(SEP.join(path))
            leaves.append(node)
            return
        for k, c in kids:
            walk(c, path + [k])
    walk(tree, [])
    return names, leaves


def leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list[Any]:
    return flatten_with_names(tree, is_leaf)[1]


def unflatten(tree, new_leaves: list[Any]):
    """A container of `tree`'s structure holding `new_leaves` in visiting
    order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        return next(it)
    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def tree_map(fn: Callable, tree, *rest):
    """fn applied leaf by leaf over trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("tree_map: the trees differ in structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
