"""Tree paths over the port's nested containers — the path half of
``repro/common/pytree.py``.

The reference walks jax tree paths (``DictKey`` / ``SequenceKey`` /
``GetAttrKey``); the port's trees are nested dicts, lists, tuples and
dataclasses of tensors, walked here with entries of the same attribute
names. So ``path_names`` gives the reference's key strings for the same
tree: a parameter file's ``params/stages/0/0/mixer/vq/codebook`` is one
string in either package. Leaves come in jax's order (dict keys sorted).
Nothing is registered: the port has no pytree registry.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable


@dataclasses.dataclass(frozen=True)
class DictKey:
    key: Any


@dataclasses.dataclass(frozen=True)
class SequenceKey:
    idx: int


@dataclasses.dataclass(frozen=True)
class GetAttrKey:
    name: str


def path_entry_name(p: Any) -> str:
    """Readable name for one tree-path entry (DictKey / SequenceKey /
    GetAttrKey)."""
    for attr in ("key", "name", "idx"):
        if hasattr(p, attr):
            return str(getattr(p, attr))
    return str(p)


def path_names(path) -> tuple[str, ...]:
    return tuple(path_entry_name(p) for p in path)


def tree_map_with_path(fn: Callable, tree):
    """The tree with every leaf replaced by ``fn(path, leaf)``, called in
    leaf order (dict keys sorted); containers keep their type and dicts
    their key order (a dataclass is rebuilt with ``dataclasses.replace``).
    ``None`` is an empty subtree."""

    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: walk(node[k], path + (DictKey(k),)) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (SequenceKey(i),)) for i, v in enumerate(node))
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: walk(getattr(node, f.name), path + (GetAttrKey(f.name),))
                for f in dataclasses.fields(node)})
        return fn(path, node)

    return walk(tree, ())


def tree_flatten_with_path(tree) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] of every leaf, in leaf order."""
    out = []
    tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure holding ``leaves`` (in leaf order)."""
    it = iter(leaves)
    return tree_map_with_path(lambda _p, _leaf: next(it), like)


def tensor_leaves(tree) -> list:
    """Every tensor of ``tree``: a leaf laid out on a grid
    (``distributed.context.Blocks``) gives its distinct block tensors."""
    out = []
    for leaf in tree_leaves(tree):
        out.extend(leaf.distinct() if hasattr(leaf, "distinct") else (leaf,))
    return out


def with_tensor_leaves(like, tensors):
    """``like``'s structure (laid-out leaves included) holding ``tensors``
    in ``tensor_leaves`` order."""
    it = iter(tensors)

    def one(_p, leaf):
        if hasattr(leaf, "distinct"):
            return leaf.with_tensors([next(it) for _ in leaf.distinct()])
        return next(it)

    return tree_map_with_path(one, like)
