"""Tree helpers over the port's parameter and state containers: nested
dicts (visited in sorted key order, as JAX orders pytree dicts), lists,
tuples and NamedTuples, with tensors (or any other object) as leaves.
`None` is an empty subtree. Paths name leaves as "a/b/0/c" (NamedTuple
fields by name), for checkpoint manifests and error messages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


_MISSING = object()


def _children(tree) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(tree)]
    raise TypeError(f"not a container: {type(tree).__name__}")


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """[(path, leaf)] in a fixed order."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for name, child in _children(tree):
        out.extend(flatten_with_paths(child, f"{prefix}/{name}" if prefix
                                      else name))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like `like` whose leaves are `new_leaves`, in
    `leaves(like)` order."""
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            leaf = next(it, _MISSING)
            if leaf is _MISSING:
                raise ValueError("fewer leaves than the tree holds")
            return leaf
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        kids = [build(c) for _, c in _children(node)]
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*kids)
        return type(node)(kids)

    out = build(like)
    if next(it, _MISSING) is not _MISSING:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """fn applied leaf-wise to `tree` and trees of the same structure."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(*args) for args in zip(leaves(tree), *others,
                                                       strict=True)])
