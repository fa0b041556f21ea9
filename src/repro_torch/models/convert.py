"""Weights across the two packages.

`to_reference(model)` is the port's `Model` as the JAX package's parameter
tree: nested dicts under the same keys, each layer stack's leaves stacked
on a leading layer axis, an `RMSNorm` as its weight.  `from_reference(cfg,
tree, device)` is the inverse: a `Model` holding the values of a JAX tree
(`jax.device_get(repro.models.model.init_params(cfg, key))`: numpy arrays,
bf16 as `ml_dtypes.bfloat16`) or of `to_reference`'s output.

Since the leaves, their dtypes and `core.pytree`'s leaf order are JAX's,
`ckpt.checkpoint.tree_to_bytes(to_reference(m))` is byte for byte the JAX
package's `tree_to_bytes` of the same weights.

`bind(model, tree)` maps the `Model`'s parameter names to the tree's
tensors without copying: a stacked leaf is cut into per-layer views by one
`torch.unbind` (whose backward is one `stack`, where indexing each layer
would cost a full-size zero tensor a layer).  `models.model.forward` runs
a tree through `torch.func.functional_call` on it; `holding(cfg, tree)`
is a `Model` whose parameters are those views (decode on a tree).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch
from torch import nn

from .config import ArchConfig
from .layers import RMSNorm
from .model import Model, init_params


def _leaves(module: nn.Module, path: tuple = (), idx: int | None = None
            ) -> Iterator[tuple[tuple, int | None, torch.Tensor]]:
    """(path in the JAX tree, layer index in its stack or None, tensor)."""
    if isinstance(module, RMSNorm):
        yield path, idx, module.weight
        return
    for name, p in module.named_parameters(recurse=False):
        yield path + (name,), idx, p
    for name, child in module.named_children():
        if isinstance(child, nn.ModuleList):
            for i, layer in enumerate(child):
                yield from _leaves(layer, path + (name,), i)
        else:
            yield from _leaves(child, path + (name,), idx)


def _set(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _paths(tree, path: tuple = ()) -> Iterator[tuple]:
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _paths(sub, path + (key,))
    else:
        yield path


def to_reference(model: Model) -> dict:
    """The JAX package's parameter tree of `model` (tensors on its device;
    stacked leaves are new tensors, the rest the parameters themselves,
    detached)."""
    tree: dict = {}
    stacks: dict[tuple, list] = {}
    for path, idx, p in _leaves(model):
        if idx is None:
            _set(tree, path, p.detach())
        else:
            stacks.setdefault(path, []).append(p.detach())
    for path, ts in stacks.items():
        _set(tree, path, torch.stack(ts))
    return tree


def bind(model: Model, tree: dict) -> dict[str, torch.Tensor]:
    """{parameter name of `model`: the tensor of `tree` it stands for}.
    Raises ValueError when the tree's leaf paths are not the model's."""
    names = {id(p): name for name, p in model.named_parameters()}
    leaves = list(_leaves(model))
    want = {path for path, _, _ in leaves}
    have = set(_paths(tree))
    if want != have:
        raise ValueError(f"tree leaves differ from the model's: missing "
                         f"{sorted(want - have)}, extra {sorted(have - want)}")
    views: dict[tuple, tuple] = {}
    out = {}
    for path, idx, p in leaves:
        leaf = tree
        for key in path:
            leaf = leaf[key]
        if idx is not None:
            if path not in views:
                views[path] = torch.unbind(_whole_layer_axis(leaf), 0)
            leaf = views[path][idx]
        out[names[id(p)]] = leaf
    return out


def _whole_layer_axis(leaf):
    """`leaf`, gathered along its layer axis where it is a DTensor sharded
    there (a spec may put "model" on it): DTensor cannot unbind a sharded
    dimension."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(leaf, DTensor) and any(p.is_shard(0)
                                         for p in leaf.placements):
        return leaf.redistribute(leaf.device_mesh, [
            Replicate() if p.is_shard(0) else p for p in leaf.placements])
    return leaf


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)  # (np.ascontiguousarray makes 0-d arrays 1-d)
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = arr.copy()  # jax.device_get's arrays are read-only; torch warns
    if arr.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy refuses it
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_reference(cfg: ArchConfig, tree: dict, device=None) -> Model:
    """A `Model` of `cfg` on `device` (None means CUDA, raising without a
    card) holding `tree`'s values.  Raises ValueError when the tree's leaf
    paths, shapes or dtypes are not the model's."""
    from ..api.registry import resolve_device

    dev = resolve_device(device)
    model = init_params(cfg, device="meta").to_empty(device=dev)
    leaves = list(_leaves(model))
    want = {path for path, _, _ in leaves}
    have = set(_paths(tree))
    if want != have:
        raise ValueError(f"tree leaves differ from {cfg.name}'s: missing "
                         f"{sorted(want - have)}, extra {sorted(have - want)}")
    with torch.no_grad():
        for path, idx, p in leaves:
            leaf = tree
            for key in path:
                leaf = leaf[key]
            t = _as_tensor(leaf if idx is None else leaf[idx])
            if tuple(t.shape) != tuple(p.shape) or t.dtype != p.dtype:
                raise ValueError(
                    f"{'/'.join(path)}[{idx}]: {tuple(t.shape)} {t.dtype}, "
                    f"the model holds {tuple(p.shape)} {p.dtype}")
            p.copy_(t)
    return model


def holding(cfg: ArchConfig, tree: dict) -> Model:
    """A `Model` of `cfg` whose parameters are `tree`'s tensors, with no
    copy: each layer's are views of the stacked leaves (`bind`).  It runs
    where the tensors are (DTensors among them: the dry-run decodes on
    one); the parameters take no gradient."""
    model = init_params(cfg, device="meta")
    for name, t in bind(model, tree).items():
        owner, _, leaf = name.rpartition(".")
        model.get_submodule(owner)._parameters[leaf] = nn.Parameter(
            t, requires_grad=False)
    return model
