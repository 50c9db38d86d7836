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
    _walk(tree, [], is_leaf, names, leaves)
    return names, leaves


def _walk(node, path: list[str], is_leaf, names: list, leaves: list) -> None:
    """Append the leaves under `node` and their names. A module-level
    function, not a closure: a recursive closure is a reference cycle
    that holds every leaf it saw until the cycle collector runs (a model's
    weights on the card, for one)."""
    if node is None:
        return
    kids = None if is_leaf is not None and is_leaf(node) \
        else _children(node)
    if kids is None:
        names.append(SEP.join(path))
        leaves.append(node)
        return
    for k, c in kids:
        _walk(c, path + [k], is_leaf, names, leaves)


def leaves(tree, is_leaf: Callable[[Any], bool] | None = None) -> list[Any]:
    return flatten_with_names(tree, is_leaf)[1]


def unflatten(tree, new_leaves: list[Any]):
    """A container of `tree`'s structure holding `new_leaves` in visiting
    order."""
    it = iter(new_leaves)
    out = _build(tree, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def _build(node, it):
    """`node`'s structure with leaves taken from `it` (module-level for the
    reason `_walk` is)."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(c, it) for c in node)
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    """fn applied leaf by leaf over trees of one structure."""
    flat = [leaves(t) for t in (tree, *rest)]
    if any(len(f) != len(flat[0]) for f in flat):
        raise ValueError("tree_map: the trees differ in structure")
    return unflatten(tree, [fn(*xs) for xs in zip(*flat)])
