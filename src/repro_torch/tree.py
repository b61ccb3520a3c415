"""Nested containers of tensors (parameters, optimizer state, batches):
the few tree operations the training path needs, in the JAX package's leaf
order, so that a checkpoint's leaves line up between the two packages.

The order is `jax.tree_util.tree_flatten`'s: dict entries by sorted key,
a NamedTuple's fields in their declared order, list and tuple entries by
index; None holds no leaf.  A leaf's name is its path joined with "/":
dict keys, NamedTuple field names and sequence indices
(`checkpoint.checkpointer` writes it into the manifest).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node) -> List[Tuple[str, Any]]:
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    return [(str(i), v) for i, v in enumerate(node)]


def _is_node(node) -> bool:
    return isinstance(node, (dict, list, tuple))


def named_leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path name, leaf)] in flatten order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out.extend(named_leaves(child, f"{prefix}/{key}" if prefix else key))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in named_leaves(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like `like` whose leaves are `new_leaves`, in flatten
    order (dicts keep `like`'s key order)."""
    it: Iterator = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            built = {k: None for k in node}
            for k in sorted(node):
                built[k] = build(node[k])
            return built
        items = [build(v) for v in node]
        return type(node)(*items) if _is_namedtuple(node) else type(node)(items)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn over the leaves of `tree` and the same-shaped `rest`."""
    others = [leaves(r) for r in rest]
    mine = leaves(tree)
    if any(len(o) != len(mine) for o in others):
        raise ValueError("trees of different leaf counts")
    return unflatten(tree, [fn(*args) for args in zip(mine, *others)])
