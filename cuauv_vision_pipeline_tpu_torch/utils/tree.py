"""Trees of dicts, lists and tuples: flatten, rebuild, map.

The small subset of ``jax.tree_util`` the engine needs (result/posts trees
of tensors or arrays). Dict order is insertion order; anything that is not a
dict, list or tuple is a leaf.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

TreeDef = Any


def tree_flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    """Leaves in depth-first order, and the structure to rebuild them."""
    leaves: List[Any] = []

    def walk(node: Any) -> TreeDef:
        if isinstance(node, dict):
            return (dict, tuple(node), tuple(walk(v) for v in node.values()))
        if isinstance(node, (list, tuple)):
            return (type(node), len(node), tuple(walk(v) for v in node))
        leaves.append(node)
        return None

    return leaves, walk(tree)


def tree_unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(spec: TreeDef) -> Any:
        if spec is None:
            return next(it)
        kind, keys, children = spec
        values = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, values))
        return kind(values)

    return build(treedef)


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [fn(x) for x in leaves])
