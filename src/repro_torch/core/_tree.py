"""A small pytree: flatten/unflatten over dict, list, tuple and None.

Leaf order is ``jax.tree``'s: dict keys sorted, lists and tuples in order,
``None`` an empty node.  Handle order, byte counters and traces of the
runtime follow this order, so it must agree with the reference.  (PyTorch's
private ``torch.utils._pytree`` keeps dict insertion order instead.)
Anything that is not one of the four container types is a leaf.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple


@dataclass(frozen=True)
class TreeDef:
    """Structure of a flattened tree; equal structures compare equal."""

    kind: str                        # "leaf" | "none" | "dict" | "list" | "tuple"
    keys: Tuple[Any, ...] = ()       # dict only: sorted keys
    children: Tuple["TreeDef", ...] = ()

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
        return vals if d.kind == "list" else tuple(vals)

    out = rec(treedef)
    if next(it, _END) is not _END:
        raise ValueError("too many leaves for tree structure")
    return out


_END = object()


def leaves(tree: Any) -> List[Any]:
    return flatten(tree)[0]
