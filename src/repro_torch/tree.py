"""Nested containers of tensors ("trees"): the port's counterpart of the
few ``jax.tree`` functions the training side uses.

Leaves come in ``jax.tree.flatten``'s order: dict keys sorted at every
level, lists, tuples and named tuples in order.  A coordinate's bucket in the gradient
sketch depends on its index in the flat vector, so the flat order must be
the reference's exactly."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [tree]


def tree_unflatten(like: Any, leaves) -> Any:
    """A tree shaped like ``like`` (its leaves are not read) holding
    ``leaves`` in :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [build(x) for x in node]
            return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
        return next(it)

    return build(like)


def skeleton(tree: Any) -> Any:
    """``tree``'s structure with every leaf replaced by ``None``."""
    return tree_unflatten(tree, [None] * len(tree_leaves(tree)))


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf across trees of one structure."""
    columns = zip(tree_leaves(tree), *(tree_leaves(t) for t in rest))
    return tree_unflatten(tree, [fn(*leaves) for leaves in columns])
