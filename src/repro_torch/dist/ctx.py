"""Mesh context for model code: logical-axis sharding constraints; the port
of `repro/dist/ctx.py`.

Model layers annotate activations with *logical* axis names
(`constrain(x, "batch", None, "model")`); this module resolves them against
whatever mesh is active:

  * no mesh (single-device runs, simulator runs): no-op,
  * a mesh without the named axis, or a non-divisible dimension: that axis is
    dropped by `sharding.guard` (replicated) instead of erroring,
  * "batch" maps to all data-parallel axes present (("pod", "data") on the
    multi-pod production mesh, ("data",) on host meshes).

The mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
dimensions.  Keeping the resolution here (not in the layers) lets the same
model code run unmodified on one device, on the 4x2 host mesh and on the
16x16(+pod) production meshes of the dry-run.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch

from .sharding import PartitionSpec, guard, placements

# logical name -> candidate mesh axes (first all present are combined)
_LOGICAL = {"batch": ("pod", "data")}

_ACTIVE = threading.local()  # set by activation_sharding()


@contextlib.contextmanager
def activation_sharding(mesh, multi_pod: bool = False):
    """Scope in which `constrain` resolves against `mesh`.

    Entered by the dry-run around tracing; `multi_pod=False` keeps the
    "batch" logical axis off the pod axis even when the mesh has one
    (pipeline-style pod use)."""
    prev = getattr(_ACTIVE, "ctx", None)
    _ACTIVE.ctx = (mesh, multi_pod)
    try:
        yield
    finally:
        _ACTIVE.ctx = prev


def current_mesh():
    """The mesh `constrain` resolves against: the innermost
    `activation_sharding` scope, else None.  (The JAX package also reads
    the ambient `with mesh:` context; torch has no such context, so the
    scope is the only source here.)"""
    ctx = getattr(_ACTIVE, "ctx", None)
    return None if ctx is None else ctx[0]


def _resolve(name, axis_sizes: dict[str, int]):
    if name is None:
        return None
    if isinstance(name, tuple):
        kept = tuple(a for a in name if a in axis_sizes)
        return kept if kept else None
    if name in _LOGICAL:
        kept = tuple(a for a in _LOGICAL[name] if a in axis_sizes)
        if not kept:
            return None
        return kept if len(kept) > 1 else kept[0]
    return name if name in axis_sizes else None


def constrain(x, *axes):
    """`x` laid out as `PartitionSpec(*axes)` on the active mesh, with
    logical-name resolution and divisibility guarding; identity when no
    mesh is active.  Under a mesh a DTensor is `redistribute`d to the
    spec's placements (a no-op when it has them already) and a plain
    tensor is returned unchanged: it is the same value on every rank."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, layout(tuple(x.shape), *axes))


def layout(shape: tuple, *axes) -> tuple:
    """The DTensor placements `constrain(x, *axes)` gives a tensor of
    `shape` on the active mesh."""
    mesh = current_mesh()
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if not _ACTIVE.ctx[1]:
        sizes.pop("pod", None)  # pod axis not batch-parallel in this scope
    spec = PartitionSpec(*(_resolve(a, sizes) for a in axes))
    return placements(guard(spec, shape, sizes), mesh)


def einsum(eq: str, *ops):
    """`torch.einsum(eq, *ops)`; under a mesh, on DTensors, run on each
    rank's shards.  For each mesh dimension: if one operand is a partial
    sum over it and the others are replicated, the result is a partial
    sum (`Partial`: an einsum is linear in each operand).  Else partial
    sums are reduced first, and of the indices the operands shard over it
    one is kept, an output index if there is one: every operand holding
    it is sharded on it, the others are replicated, and the local einsums
    compute that index's blocks (a sharded output index: `Shard`; a
    contracted one: each rank's partial sum, `Partial`).  (DTensor's own
    einsum folds the batch indices into one dimension and, in some
    versions, refuses to when a later one of them is sharded.)  Without a
    mesh, or with a plain operand, it is `torch.einsum`."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None or not all(isinstance(t, DTensor) for t in ops):
        return torch.einsum(eq, *ops)
    return _on_shards(mesh, eq, ops, functools.partial(torch.einsum, eq))


def matmul(x, w):
    """`x @ w`, x (..., d) and w a (d, f) weight.  Under a mesh, on
    DTensors, on each rank's shards by `einsum`'s rule (the local product
    is `x @ w`): DTensor's own matmul flattens x's leading dimensions,
    which turns a dimension sharded after the first into a strided shard,
    and on the 2x16x16 mesh its sharding propagation then prices
    redistributions for minutes an op.  Otherwise it is `x @ w`."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None or not (isinstance(x, DTensor) and isinstance(w, DTensor)):
        return x @ w
    lead = "abceghijkl"[:x.ndim - 1]
    return _on_shards(mesh, f"{lead}d,df->{lead}f", (x, w), torch.matmul)


def _on_shards(mesh, eq: str, ops, local_fn):
    """`local_fn` (the einsum `eq`) on each rank's shards of the DTensors
    `ops`, laid out by `einsum`'s rule; the result as a DTensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    ops = list(ops)

    def placed(t, m, p):
        return t.redistribute(mesh, t.placements[:m] + (p,)
                              + t.placements[m + 1:])

    placements, sharded_dims = [], []
    for m in range(mesh.ndim):
        kinds = [t.placements[m] for t in ops]
        if (sum(p.is_partial() for p in kinds) == 1 and Partial() in kinds
                and all(p.is_partial() or p.is_replicate() for p in kinds)):
            sharded_dims.append(m)
            placements.append(Partial())
            continue
        ops = [placed(t, m, Replicate()) if t.placements[m].is_partial()
               else t for t in ops]
        sharded = [ins[i][t.placements[m].dim] for i, t in enumerate(ops)
                   if t.placements[m].is_shard()]
        if not sharded:
            placements.append(Replicate())
            continue
        index = next((c for c in sharded if c in out), sharded[0])
        ops = [placed(t, m, Shard(ins[i].index(index)) if index in ins[i]
                      else Replicate()) for i, t in enumerate(ops)]
        sharded_dims.append(m)
        placements.append(Shard(out.index(index)) if index in out
                          else Partial())
    sizes = {c: n for i, t in enumerate(ops) for c, n in zip(ins[i], t.shape)}
    local = local_fn(*(local_shard(t, sharded_dims) for t in ops))
    shape = torch.Size(sizes[c] for c in out)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=shape, stride=_global_stride(local, shape))


def _global_stride(local, shape) -> tuple:
    """The strides of a tensor of `shape` laid out as `local`, a shard of
    it, are: its dimensions in the same order of stride."""
    order = sorted(range(local.ndim), key=lambda d: (local.stride(d),
                                                     local.shape[d]))
    stride, step = [0] * local.ndim, 1
    for d in order:
        stride[d] = step
        step *= shape[d]
    return tuple(stride)


class _LocalShard(torch.autograd.Function):
    """`DTensor.to_local` with its backward: the shard's gradient as a
    DTensor of the given placements."""

    @staticmethod
    def forward(ctx, t, grad_placements):
        ctx.spec = (t.device_mesh, grad_placements, t.shape)
        local = t._local_tensor
        return local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        while isinstance(grad, DTensor):  # see local_shard
            grad = grad._local_tensor
        mesh, placements, shape = ctx.spec
        return DTensor.from_local(grad, mesh, placements, run_check=False,
                                  shape=shape,
                                  stride=_global_stride(grad, shape)), None


def local_shard(t, varies=()):
    """`t.to_local()`, differentiable.  `varies` names the mesh dimensions
    over which `t` is replicated but the local computation that follows
    differs by rank (another operand is sharded there): the gradient is
    each rank's partial sum over them (`Partial`), and `t`'s placement
    elsewhere; a partial sum's gradient is the same on every rank
    (`Replicate`).  (Under `torch.utils.checkpoint`'s recomputation torch
    2.11 can hand `to_local`'s backward a DTensor gradient, which it wraps
    in another DTensor; here such a gradient's own shard is taken.)"""
    from torch.distributed.tensor import Partial, Replicate

    grad = tuple(Partial() if m in varies and p.is_replicate()
                 else Replicate() if p.is_partial() else p
                 for m, p in enumerate(t.placements))
    return _LocalShard.apply(t, grad)


def along(fn, x, dims):
    """`fn(x)` for an `fn` that works along the dimensions `dims` of `x`
    and independently at every index of the others, which it keeps (a
    cumulative sum, a gather along one dimension).  Under a mesh, on a
    DTensor, `fn` runs on each rank's shard: `x` is first gathered on
    `dims` where it is sharded there and reduced where it is a partial
    sum, and the result is laid out as `x` then is.  (torch 2.11's DTensor
    has no rule for some of these ops' backward: `flip`, `cumsum`'s;
    `index_put` with a `None` index, that of `x[:, idx]`.)  Otherwise it
    is `fn(x)`."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return fn(x)
    dims = {d % x.ndim for d in dims}
    placements = tuple(
        Replicate() if p.is_partial() or (p.is_shard() and p.dim in dims)
        else p for p in x.placements)
    x = x.redistribute(mesh, placements)
    return DTensor.from_local(fn(local_shard(x)), mesh, placements,
                              run_check=False)


def lookup(table, ids):
    """`table[ids]`: rows of an embedding table.  Under a mesh, on
    DTensors, each rank looks its ids up in its own shard of the table:
    rows outside a vocab shard read 0 and the shards' results sum
    (`Partial`) over the mesh dimensions that split the vocab; the ids
    keep their sharding, the features theirs.  (DTensor's own rule for
    this gather, in some versions, cannot take its gradient.)"""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = current_mesh()
    if mesh is None or not (isinstance(table, DTensor)
                            and isinstance(ids, DTensor)):
        return table[ids]
    out_dims = ids.ndim + 1
    vocab = [m for m, p in enumerate(table.placements) if p == Shard(0)]
    ids = ids.redistribute(mesh, tuple(
        Replicate() if table.placements[m].is_shard() else p
        for m, p in enumerate(ids.placements)))
    placements = []
    for m, p in enumerate(table.placements):
        if m in vocab:
            placements.append(Partial())
        elif p.is_shard():
            placements.append(Shard(out_dims - 1))
        else:
            placements.append(ids.placements[m])
    rows = local_shard(table, [m for m, p in enumerate(ids.placements)
                               if p.is_shard()])
    local_ids = ids.to_local()
    if vocab:
        n, offset = compute_local_shape_and_global_offset(
            table.shape, mesh, table.placements)
        local_ids = local_ids - offset[0]
        inside = (local_ids >= 0) & (local_ids < n[0])
        out = torch.where(inside[..., None],
                          rows[torch.where(inside, local_ids, 0)], 0)
    else:
        out = rows[local_ids]
    shape = torch.Size(tuple(ids.shape) + tuple(table.shape[1:]))
    return DTensor.from_local(out, mesh, placements, run_check=False,
                              shape=shape, stride=_global_stride(out, shape))


def split_heads(x, shape):
    """`x.reshape(shape)`, where `x`'s last dimension splits into the last
    two of `shape` (heads, head size).  Under a mesh, a DTensor sharded
    on that dimension over more ranks than the heads divide is gathered
    there first: DTensor shards a split dimension by its leading part
    only.  Otherwise it is `reshape`."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = current_mesh()
    if mesh is not None and isinstance(x, DTensor):
        last = x.ndim - 1
        ranks = 1
        for m, p in enumerate(x.placements):
            if p.is_shard(last):
                ranks *= mesh.shape[m]
        if shape[-2] % ranks:
            x = x.redistribute(mesh, [Replicate() if p.is_shard(last) else p
                                      for p in x.placements])
    return x.reshape(shape)
