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


# The walkers are module-level functions that take their accumulators as
# arguments: a nested recursive function refers to itself through its
# closure, a reference cycle that would keep every leaf it collected
# alive until the garbage collector runs (a train step's whole new state).

def _flatten(node, leaves: list) -> TreeDef:
    kind = type(node)  # exact types: a subclass is a leaf, as in JAX
    if node is None:
        return TreeDef("none")
    if kind is OrderedDict:
        keys = tuple(node)
        return TreeDef("odict", keys,
                       tuple(_flatten(node[k], leaves) for k in keys))
    if kind is dict or kind is defaultdict:
        keys = tuple(sorted(node))
        return TreeDef("dict" if kind is dict else "ddict",
                       keys if kind is dict
                       else (node.default_factory,) + keys,
                       tuple(_flatten(node[k], leaves) for k in keys))
    if kind is list:
        return TreeDef("list", None, tuple(_flatten(c, leaves) for c in node))
    if kind is tuple or (isinstance(node, tuple)
                         and hasattr(kind, "_fields")):  # namedtuple
        return TreeDef("tuple", kind, tuple(_flatten(c, leaves) for c in node))
    leaves.append(node)
    return TreeDef("leaf")


def tree_flatten(tree: Any) -> tuple[list, TreeDef]:
    """(leaves, treedef) in the JAX package's leaf order."""
    leaves: list = []
    treedef = _flatten(tree, leaves)
    return leaves, treedef


def _build(td: TreeDef, it):
    if td.kind == "leaf":
        return next(it)
    if td.kind == "none":
        return None
    kids = [_build(c, it) for c in td.children]
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


def tree_unflatten(treedef: TreeDef, leaves) -> Any:
    """The tree of `treedef`'s structure holding `leaves` in order."""
    it = iter(leaves)
    tree = _build(treedef, it)
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


def _up_to(td: TreeDef, node, out: list) -> None:
    if td.kind == "leaf":
        out.append(node)
    elif td.kind in ("dict", "odict", "ddict"):
        keys = td.node[1:] if td.kind == "ddict" else td.node
        if set(keys) != set(node):
            raise ValueError(f"keys {sorted(node)} differ from {sorted(keys)}")
        for key, child in zip(keys, td.children):
            _up_to(child, node[key], out)
    elif td.kind != "none":
        if len(node) != len(td.children):
            raise ValueError(f"{len(node)} children, the structure has "
                             f"{len(td.children)}")
        for child, sub in zip(td.children, node):
            _up_to(child, sub, out)


def flatten_up_to(treedef: TreeDef, tree: Any) -> list:
    """The subtrees of `tree` at `treedef`'s leaf positions, in leaf order
    (JAX's `treedef.flatten_up_to`): an optimizer state holding one dict
    per parameter yields those dicts."""
    out: list = []
    _up_to(treedef, tree, out)
    return out
