"""Nested-dict "pytrees" of tensors (↔ deeplearning4j_tpu/utils/pytree.py).

The JAX package names every leaf of a variables tree by its path,
``a/b/c`` (``flatten_with_names``); checkpoints and the port's parameters
use the same names. This is the port's own copy over plain nested dicts,
lists and tuples (namedtuples too), and dataclasses registered with :func:`register_dataclass`
(``TrainState``): dict keys are visited in sorted order and dataclass fields
in declaration order, as ``jax.tree_util`` does, so both packages list and
name leaves alike (``opt_state/m/embeddings/word``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, List, Tuple

_DATACLASS_NODES: set = set()


def register_dataclass(cls):
    """Class decorator (↔ ``jax.tree_util.register_dataclass``): instances
    are tree nodes whose children are their fields."""
    _DATACLASS_NODES.add(cls)
    return cls


def _children(tree) -> Iterable[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if isinstance(tree, (list, tuple)):
        return ((str(i), v) for i, v in enumerate(tree))
    if type(tree) in _DATACLASS_NODES:
        return ((f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree))
    return ()


def _is_leaf(tree) -> bool:
    return not (isinstance(tree, (dict, list, tuple))
                or type(tree) in _DATACLASS_NODES)


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


def _sequence(like, items):
    """A list or tuple of ``like``'s type holding ``items``; a namedtuple
    (``LSTMState``) takes them as its fields."""
    if hasattr(like, "_fields"):
        return type(like)(*items)
    return type(like)(items)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over one or more trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return _sequence(tree, [tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if type(tree) in _DATACLASS_NODES:
        return type(tree)(**{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    return fn(tree, *rest)


def tree_map_with_names(fn: Callable, tree, prefix: str = ""):
    """Like :func:`tree_map` over one tree, with ``fn(name, leaf)``; the
    names are those :func:`flatten_with_names` gives."""
    if _is_leaf(tree):
        return fn(prefix, tree)
    rebuilt = {name: tree_map_with_names(
        fn, child, f"{prefix}/{name}" if prefix else name)
        for name, child in _children(tree)}
    if isinstance(tree, dict):
        return {k: rebuilt[str(k)] for k in tree}
    if isinstance(tree, (list, tuple)):
        return _sequence(tree, [rebuilt[str(i)] for i in range(len(tree))])
    return type(tree)(**rebuilt)


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_names(tree)]
