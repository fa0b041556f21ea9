"""Nested containers of arrays ("trees") flattened in the JAX package's
leaf order, so the same leaves give the same checkpoint bytes.

The nodes are `jax.tree_util`'s: an exact `dict` and a `defaultdict` by
sorted key, an exact `OrderedDict` (what `torch.nn.Module.state_dict()`
returns) in insertion order, an exact `list` or `tuple` and any namedtuple
in order, and `None` as a node with no leaves.  Anything else is a leaf: a
torch tensor, a numpy array, a Python scalar, and every other subclass of
list, tuple or dict (`torch.Size` among them), as in JAX.
"""
from __future__ import annotations

from collections import OrderedDict, defaultdict
from dataclasses import dataclass
from typing import Any, Callable

_END = object()


@dataclass(frozen=True)
class TreeDef:
    """The structure of a flattened tree: `kind` is "leaf", "none",
    "dict", "odict", "ddict", "list" or "tuple"; `node` holds the keys
    (dicts; a defaultdict's are preceded by its `default_factory`) or the
    tuple type (namedtuples); `children` the subtrees' structures."""

    kind: str
    node: Any = None
    children: tuple = ()

    def __str__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        inner = ", ".join(map(str, self.children))
        if self.kind in ("dict", "odict", "ddict"):
            keys = self.node[1:] if self.kind == "ddict" else self.node
            inner = "{" + ", ".join(f"{k!r}: {c}"
                                    for k, c in zip(keys, self.children)) + "}"
            return {"dict": inner, "odict": f"OrderedDict({inner})",
                    "ddict": f"defaultdict({inner})"}[self.kind]
        if self.kind == "list":
            return "[" + inner + "]"
        return f"{self.node.__name__}({inner})"


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    """(leaves, treedef) in the JAX package's leaf order."""
    leaves: list = []

    def walk(node) -> TreeDef:
        kind = type(node)  # exact types: a subclass is a leaf, as in JAX
        if node is None:
            return TreeDef("none")
        if kind is OrderedDict:
            keys = tuple(node)
            return TreeDef("odict", keys, tuple(walk(node[k]) for k in keys))
        if kind is dict or kind is defaultdict:
            keys = tuple(sorted(node))
            return TreeDef("dict" if kind is dict else "ddict",
                           keys if kind is dict
                           else (node.default_factory,) + keys,
                           tuple(walk(node[k]) for k in keys))
        if kind is list:
            return TreeDef("list", None, tuple(walk(c) for c in node))
        if kind is tuple or (isinstance(node, tuple)
                             and hasattr(kind, "_fields")):  # namedtuple
            return TreeDef("tuple", kind, tuple(walk(c) for c in node))
        leaves.append(node)
        return TreeDef("leaf")

    treedef = walk(tree)
    return leaves, treedef


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of `treedef`'s structure holding `leaves` in order."""
    it = iter(leaves)

    def build(td: TreeDef):
        if td.kind == "leaf":
            return next(it)
        if td.kind == "none":
            return None
        kids = [build(c) for c in td.children]
        if td.kind == "dict":
            return dict(zip(td.node, kids))
        if td.kind == "odict":
            return OrderedDict(zip(td.node, kids))
        if td.kind == "ddict":
            return defaultdict(td.node[0], zip(td.node[1:], kids))
        if td.kind == "list":
            return kids
        if td.node is tuple:
            return tuple(kids)
        return td.node(*kids)  # namedtuple

    tree = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the tree structure holds")
    return tree


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` applied leaf-wise over `tree` and the same-structured `rest`."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, td in others:
        if td != treedef:
            raise ValueError(f"tree structures differ: {treedef} vs {td}")
    return tree_unflatten(treedef, [fn(*xs) for xs in zip(
        leaves, *(o[0] for o in others))])
