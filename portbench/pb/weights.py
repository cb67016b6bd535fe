"""The run's weights, made on the device from the seed.

The program's parameter tree gives only the leaves' names, shapes and
dtypes (``Model.init_abstract``, on the ``meta`` device).  The values come
from here: the leaves of one dtype are views into one flat buffer on the
device, which one ``normal_`` call fills from a generator on the device
seeded with the run's seed, in the dtype the leaves are served in; then the
configuration's ``init`` rules (first match of a dotted leaf path against a
glob wins) scale each leaf, ``["normal", std]``, or set it,
``["const", value]``.  The same seed gives the same weights in any process,
and :meth:`Weights.refill` redraws them in place for another seed.
"""
from __future__ import annotations

import fnmatch
from typing import Any, Dict, List, Tuple

import torch


def leaves(tree: Any, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves(v, f"{prefix}{k}.")
        return out
    return [(prefix[:-1], tree)]


def _rule(path: str, rules: List[List[Any]]) -> Tuple[str, float]:
    for pattern, kind, value in rules:
        if fnmatch.fnmatchcase(path, pattern):
            return kind, float(value)
    raise ValueError(f"no init rule matches leaf {path!r}")


class Weights:
    """``params``: a tree shaped like ``template`` (meta tensors) on
    ``device``, drawn from ``seed``."""

    def __init__(self, template: Any, rules: List[List[Any]], seed: int,
                 device: torch.device) -> None:
        self.rules = rules
        named = leaves(template)
        sizes: Dict[torch.dtype, int] = {}
        for _, t in named:
            sizes[t.dtype] = sizes.get(t.dtype, 0) + t.numel()
        self.flats = {dt: torch.empty(n, dtype=dt, device=device)
                      for dt, n in sizes.items()}
        at = dict.fromkeys(sizes, 0)
        views = {}
        for path, t in named:
            a = at[t.dtype]
            views[path] = self.flats[t.dtype][a:a + t.numel()].view(t.shape)
            at[t.dtype] = a + t.numel()
        self.params = self._tree(template, views, "")
        self._named = leaves(self.params)
        self.refill(seed)

    def _tree(self, template: Any, views: Dict[str, torch.Tensor], prefix: str) -> Any:
        if isinstance(template, dict):
            return {k: self._tree(v, views, f"{prefix}{k}.") for k, v in template.items()}
        return views[prefix[:-1]]

    @torch.no_grad()
    def refill(self, seed: int) -> None:
        device = next(iter(self.flats.values())).device
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 63))
        for dt in sorted(self.flats, key=str):
            self.flats[dt].normal_(generator=gen)
        for path, t in self._named:
            kind, value = _rule(path, self.rules)
            if kind == "normal":
                t.mul_(value)
            elif kind == "const":
                t.fill_(value)
            else:
                raise ValueError(f"unknown init kind {kind!r} for {path}")

    @property
    def nbytes(self) -> int:
        return sum(f.numel() * f.element_size() for f in self.flats.values())
