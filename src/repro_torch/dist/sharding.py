"""Sharding rules: spec validation plus the spec factories the dry-run
launcher uses for params, optimizer state, batches and decode caches; the
port of `repro/dist/sharding.py`.

A spec is a `PartitionSpec`: a tuple with one entry per array dimension,
each entry `None` (replicated), a mesh axis name, or a tuple of axis names
(one dimension sharded over several mesh axes, the first the major one).
It is this package's own type, a `tuple` subclass, so `core.pytree` keeps
it as one leaf; `placements` turns it into DTensor placements.

`guard` is the single rule deciding whether a requested sharding axis is
legal for a concrete array shape: an axis (or tuple of axes) is kept only if
every named mesh axis exists and the array dimension is divisible by the
product of their sizes; otherwise that dimension falls back to replication
(None).  Dropping instead of erroring is deliberate — reduced smoke configs
frequently have dimensions (e.g. a 30-wide vocab slice) that the production
16-way model axis cannot divide, and the numerically-identical replicated
layout is always available.

The `*_specs` factories all funnel through `guard`, so every produced spec
is valid for the concrete mesh by construction:

  * params / optimizer state: tensor-parallel over "model" on the largest
    divisible dimension (vocab for embeddings, features for projections);
    scalars and non-divisible leaves replicate,
  * batches / activations: leading batch dimension over the data-parallel
    axes ("pod" joining "data" on multi-pod meshes), plus "model" on the
    trailing feature dimension of rank >= 3 activations (vocab-sharded
    logits, frame/vision embeddings),
  * decode caches: layer-stacked leaves (layers, batch, ...) shard batch on
    dim 1 and "model" on the innermost divisible feature dimension.
"""
from __future__ import annotations

from ..core.pytree import tree_map


class PartitionSpec(tuple):
    """`PartitionSpec("model", None)`: one entry per array dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def guard(spec, shape: tuple[int, ...],
          axis_sizes: dict[str, int]) -> PartitionSpec:
    """Validate `spec` for an array of `shape` on a mesh with `axis_sizes`.

    Each spec entry is kept iff all its mesh axes exist and the corresponding
    array dimension is divisible by the product of their sizes; non-divisible
    (or unknown-axis) entries are dropped to None.
    """
    entries = []
    for dim, entry in enumerate(spec):
        if entry is None:
            entries.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        known = True
        for a in axes:
            if a not in axis_sizes:
                known = False
                break
            size *= axis_sizes[a]
        if known and dim < len(shape) and shape[dim] % size == 0:
            entries.append(entry)
        else:
            entries.append(None)
    return PartitionSpec(*entries)


def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh` (a `DeviceMesh` with named
    dimensions): `Shard(d)` on each mesh dimension that some entry d names,
    `Replicate()` on the others.  A tuple entry shards its dimension over
    several mesh dimensions; DTensor splits over them in mesh order (the
    first mesh dimension major), which is the spec's order only when the
    tuple lists them in mesh order, so any other order raises ValueError."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        pos = [names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"entry {entry} is not in the mesh's axis order "
                             f"{names}")
        for p in pos:
            out[p] = Shard(dim)
    return tuple(out)


def local_shape(shape: tuple[int, ...], spec, mesh) -> tuple[int, ...]:
    """The shape of one rank's shard of an array of `shape` laid out by
    `spec` on `mesh` (a guarded spec divides every sharded dimension)."""
    local = list(shape)
    for mdim, p in enumerate(placements(spec, mesh)):
        if p.is_shard():
            local[p.dim] //= mesh.shape[mdim]
    return tuple(local)


def from_local(tree, specs, mesh):
    """Each leaf of `tree`, this rank's shard, as a DTensor laid out by
    the leaf of `specs` (a tree of the same structure) on `mesh`: no copy
    and no communication; on a mesh of one rank the shard is the tensor."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t, s: DTensor.from_local(
        t, mesh, placements(s, mesh), run_check=False), tree, specs)


# ---------------------------------------------------------------------------
# spec factories (all guarded)
# ---------------------------------------------------------------------------

def data_axes(axis_sizes: dict[str, int], multi_pod: bool):
    """The batch-dimension mesh axes: ("pod", "data") when the pod axis is
    batch-parallel, else ("data",)."""
    names = ("pod", "data") if multi_pod else ("data",)
    kept = tuple(a for a in names if axis_sizes.get(a, 0) > 1)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def _model_dim(shape: tuple[int, ...], msize: int, skip: tuple[int, ...] = ()):
    """Largest dimension divisible by the model-axis size (ties -> last)."""
    best = None
    for d, n in enumerate(shape):
        if d in skip or msize < 2 or n % msize != 0 or n < msize:
            continue
        if best is None or n >= shape[best]:
            best = d
    return best


def _param_leaf(shape, axis_sizes) -> PartitionSpec:
    msize = axis_sizes.get("model", 1)
    entries = [None] * len(shape)
    d = _model_dim(shape, msize)
    if d is not None:
        entries[d] = "model"
    return guard(PartitionSpec(*entries), shape, axis_sizes)


def param_specs(cfg, params, axis_sizes: dict[str, int], multi_pod: bool):
    """Tensor-parallel parameter layout: "model" on the largest divisible
    dimension of each leaf (vocab for embeddings, features elsewhere)."""
    del cfg, multi_pod
    return tree_map(lambda l: _param_leaf(tuple(l.shape), axis_sizes), params)


def opt_state_specs(cfg, params, opt_state, axis_sizes: dict[str, int],
                    multi_pod: bool):
    """Optimizer state follows the parameter rule leaf-by-leaf (moment
    buffers share param shapes; factored/scalar leaves fall out of the same
    divisibility rule)."""
    del cfg, params, multi_pod
    return tree_map(lambda l: _param_leaf(tuple(l.shape), axis_sizes),
                    opt_state)


def batch_specs(cfg, batch, axis_sizes: dict[str, int], multi_pod: bool):
    """Model inputs/outputs: batch dim 0 over the data axes; rank >= 3
    activations additionally put "model" on the trailing feature dim
    (vocab-sharded logits, vision/frame embeddings)."""
    del cfg
    dax = data_axes(axis_sizes, multi_pod)

    def rule(leaf):
        shape = tuple(leaf.shape)
        if not shape:
            return PartitionSpec()
        entries = [None] * len(shape)
        entries[0] = dax
        if len(shape) >= 3:
            entries[-1] = "model"
        return guard(PartitionSpec(*entries), shape, axis_sizes)

    return tree_map(rule, batch)


def cache_specs(cfg, cache, axis_sizes: dict[str, int], multi_pod: bool):
    """Decode caches are layer-stacked (layers, batch, ...): batch on dim 1,
    "model" on the innermost divisible feature dimension (head_dim / heads),
    never on the layer or batch dims."""
    del cfg
    dax = data_axes(axis_sizes, multi_pod)
    msize = axis_sizes.get("model", 1)

    def rule(leaf):
        shape = tuple(leaf.shape)
        if len(shape) < 2:
            return PartitionSpec(*([None] * len(shape)))
        entries = [None] * len(shape)
        entries[1] = dax
        for d in range(len(shape) - 1, 1, -1):
            if msize >= 2 and shape[d] % msize == 0 and shape[d] >= msize:
                entries[d] = "model"
                break
        return guard(PartitionSpec(*entries), shape, axis_sizes)

    return tree_map(rule, cache)
