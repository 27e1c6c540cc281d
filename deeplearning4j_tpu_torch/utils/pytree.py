"""Nested-dict "pytrees" of tensors (↔ deeplearning4j_tpu/utils/pytree.py).

The JAX package names every leaf of a variables tree by its path,
``a/b/c`` (``flatten_with_names``); checkpoints and the port's parameters
use the same names. This is the port's own copy over plain nested dicts,
lists and tuples: dict keys are visited in sorted order, as
``jax.tree_util`` does, so both packages list leaves in the same order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Tuple


def _children(tree) -> Iterable[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    return ()


def _is_leaf(tree) -> bool:
    return not isinstance(tree, (dict, list, tuple))


def flatten_with_names(tree) -> List[Tuple[str, Any]]:
    """[(path string, leaf)] in deterministic (sorted-key) order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, prefix):
        if _is_leaf(node):
            out.append((prefix, node))
            return
        for name, child in _children(node):
            walk(child, f"{prefix}/{name}" if prefix else name)

    walk(tree, "")
    return out


def unflatten(named: Iterable[Tuple[str, Any]]) -> Dict[str, Any]:
    """Inverse of :func:`flatten_with_names` for dict trees:
    ``[("a/b", x)]`` → ``{"a": {"b": x}}``."""
    root: Dict[str, Any] = {}
    for name, leaf in named:
        node = root
        *parents, last = name.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf
    return root


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_names(tree)]
