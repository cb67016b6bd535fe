"""A small pytree: flatten/unflatten over dict, list, tuple and None.

Leaf order is ``jax.tree``'s: dict keys sorted, lists and tuples in order,
``None`` an empty node.  Handle order, byte counters and traces of the
runtime follow this order, so it must agree with the reference.  (PyTorch's
private ``torch.utils._pytree`` keeps dict insertion order instead.)
Anything that is not one of the four container types, or a type made a node
with :func:`register_node`, is a leaf.  Other named tuples stay leaves (the
gradient fabric flattens trees of ``compression.Compressed``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Sequence, Tuple

#: type -> (children(x) -> (names, values, aux), rebuild(aux, values) -> x)
_NODES: Dict[type, Tuple[Callable, Callable]] = {}


def register_node(cls: type, children: Callable, rebuild: Callable) -> None:
    """Make ``cls`` a node: ``children(x)`` gives its children's names (its
    path keys), the children and the static rest (``aux``, kept in the
    :class:`TreeDef`), and ``rebuild(aux, values)`` makes it again."""
    _NODES[cls] = (children, rebuild)


@dataclass(frozen=True)
class TreeDef:
    """Structure of a flattened tree; equal structures compare equal."""

    kind: str                        # "leaf" | "none" | "dict" | "list" | "tuple" | "node"
    keys: Tuple[Any, ...] = ()       # dict: sorted keys; node: child names
    children: Tuple["TreeDef", ...] = ()
    node: Any = None                 # node only: (type, aux)

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)


LEAF = TreeDef("leaf")


def flatten(tree: Any) -> Tuple[List[Any], TreeDef]:
    leaves: List[Any] = []

    def rec(x: Any) -> TreeDef:
        if x is None:
            return TreeDef("none")
        if isinstance(x, dict):
            keys = tuple(sorted(x))
            return TreeDef("dict", keys, tuple(rec(x[k]) for k in keys))
        if type(x) in (list, tuple):
            return TreeDef(type(x).__name__, (), tuple(rec(v) for v in x))
        if type(x) in _NODES:
            names, values, aux = _NODES[type(x)][0](x)
            return TreeDef("node", tuple(names), tuple(rec(v) for v in values),
                           (type(x), aux))
        leaves.append(x)
        return LEAF

    return leaves, rec(tree)


def unflatten(treedef: TreeDef, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def rec(d: TreeDef) -> Any:
        if d.kind == "leaf":
            return next(it)
        if d.kind == "none":
            return None
        vals = [rec(c) for c in d.children]
        if d.kind == "dict":
            return dict(zip(d.keys, vals))
        if d.kind == "node":
            cls, aux = d.node
            return _NODES[cls][1](aux, vals)
        return vals if d.kind == "list" else tuple(vals)

    out = rec(treedef)
    if next(it, _END) is not _END:
        raise ValueError("too many leaves for tree structure")
    return out


_END = object()


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]


def flatten_with_path(tree: Any) -> Tuple[List[Tuple[Tuple[Any, ...], Any]], TreeDef]:
    """:func:`flatten` with each leaf's path: the dict keys and sequence
    indices from the root to it (``jax.tree_util.tree_flatten_with_path``'s
    keys, in the same leaf order)."""
    paths: List[Tuple[Any, ...]] = []

    def rec(x: Any, path: Tuple[Any, ...]) -> None:
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                rec(x[k], path + (k,))
        elif type(x) in (list, tuple):
            for i, v in enumerate(x):
                rec(v, path + (i,))
        elif type(x) in _NODES:
            names, values, _ = _NODES[type(x)][0](x)
            for name, v in zip(names, values):
                rec(v, path + (name,))
        else:
            paths.append(path)

    rec(tree, ())
    flat, treedef = flatten(tree)
    return list(zip(paths, flat)), treedef


def subtrees_at(treedef: TreeDef, tree: Any) -> List[Any]:
    """The subtrees of ``tree`` at the leaf positions of ``treedef``, in
    leaf order: ``tree`` must have ``treedef``'s structure down to them (a
    tree of optimizer moments against its parameters' structure, whatever
    each moment is)."""
    out: List[Any] = []

    def rec(d: TreeDef, x: Any) -> None:
        if d.kind == "leaf":
            out.append(x)
        elif d.kind == "dict":
            for k, c in zip(d.keys, d.children):
                rec(c, x[k])
        elif d.kind == "node":
            for c, v in zip(d.children, _NODES[d.node[0]][0](x)[1]):
                rec(c, v)
        elif d.kind != "none":
            for c, v in zip(d.children, x):
                rec(c, v)

    rec(treedef, tree)
    return out
