"""Per-device cost census of a traced program; the port of
`repro/launch/hlo_cost.py`, whose name it keeps so a reader finds the
counterpart.

Torch has no HLO.  The JAX package parses the compiled, SPMD-partitioned
HLO text; here `analyze(fn, *args)` runs `fn` once on meta tensors or on
meta DTensors (no memory, no device) under a dispatch mode that sees every
aten op the run issues and counts it by the JAX census's rules:

  * FLOPs: 2 x result elements x contracted size for each matmul or
    convolution; one per output element for the elementwise ops the JAX
    census lists (add, multiply, subtract, divide, maximum, minimum,
    exponential, tanh, rsqrt, power, log, negate, compare, select) and for
    reductions; a softmax, one op here, as the reductions and elementwise
    ops XLA lowers it to;
  * bytes (the memory-traffic proxy): the output bytes of every op except
    views and bookkeeping (allocation, iota, scalars), and 2 x the updated
    slice for an in-place slice update (`copy_` into a view,
    `index_copy_`, `index_put_`);
  * collectives: the functional collectives DTensor issues, as the JAX
    census's five kinds, each weighted by its ring factor over the group
    size: all-gather and reduce-scatter (n-1)/n, all-reduce 2(n-1)/n,
    all-to-all (n-1)/n, collective-permute 1.

Every figure is per DEVICE: an op on DTensors is not counted itself (its
sharding propagation runs on fake tensors at the global shape, not counted
either); the local op it issues on this rank's shard is.  (`FlopCounterMode`
counts the DTensor-level op at the global shape as well as the local one:
2x a replicated matmul's global FLOPs.)

What the JAX census does that has no analog here: it halves bf16
all-reduces and reduce-scatters that XLA on the CPU promoted to float32
(the wire runs them in bf16); torch issues them in their own dtype, so
nothing is halved.  It scales `while` bodies by their trip counts; here a
Python loop over `repeat(n, t)`, whose iterations issue the same ops on
tensors of the same shapes, runs its first iteration only under a census
(on meta tensors) and that iteration's counts are multiplied by n; any
other loop unrolls, each iteration counted as it runs.
"""
from __future__ import annotations

import math
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_COLLECTIVES = {"all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
# torch's collective op names -> the JAX census's kinds
_KIND = {"all_gather_into_tensor": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "all_reduce": "all-reduce",
         "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all",
         "send": "collective-permute", "recv": "collective-permute"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "dot", "mv", "addmv"}
_ELEMENTWISE = {
    "add", "add_", "mul", "mul_", "sub", "sub_", "rsub", "div", "div_",
    "maximum", "minimum", "clamp_min", "clamp_max", "exp", "exp_", "tanh",
    "rsqrt", "pow", "log", "neg", "eq", "ne", "lt", "le", "gt", "ge",
    "where"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
           "argmax", "argmin", "any", "all", "cumsum"}
# no memory traffic: allocation, iota, scalars, collective bookkeeping
_BOOKKEEPING = {"empty", "empty_like", "empty_strided", "arange", "lift_fresh",
                "lift_fresh_copy", "scalar_tensor", "_local_scalar_dense",
                "detach", "alias", "_unsafe_view", "wait_tensor",
                "_wrap_tensor_autograd"}
# in place into a slice: traffic is 2 x the updated slice
_SLICE_UPDATE = {"copy_": 1, "index_copy_": 3, "index_put_": 2,
                 "slice_scatter": 1, "select_scatter": 1}


_ACTIVE = threading.local()  # .census: the census counting this thread


def repeat(n: int, like: torch.Tensor):
    """`range(n)`, for a loop whose n iterations issue the same ops on
    tensors of the same shapes.  Under a census, when `like` (one of the
    loop's tensors) is on the meta device, it yields 0 alone and the ops
    of that one iteration count n times, as the JAX census multiplies a
    `while` body by its trip count; the caller makes the outputs of the
    skipped iterations (their shapes: meta tensors hold no values).
    Otherwise every iteration runs."""
    census = getattr(_ACTIVE, "census", None)
    if census is None or n <= 1 or like.device.type != "meta":
        yield from range(n)
        return
    census.scale *= n
    try:
        yield 0
    finally:
        census.scale //= n


def _tensors(*trees) -> list:
    """The tensors among `trees`' items, one level of lists deep (an aten
    op's arguments and results)."""
    out = []
    for tree in trees:
        for a in tree:
            if isinstance(a, torch.Tensor):
                out.append(a)
            elif isinstance(a, (list, tuple)):
                out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name: str, args) -> int:
    """The ranks of a functional collective's group (its group-name
    argument, resolved against the process groups)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in reversed(args):
        if isinstance(a, str):
            return _resolve_process_group(a).size()
    return 2  # unknown: conservative, as the JAX census


class _Census(TorchDispatchMode):
    """Counts the ops issued on plain (local) tensors."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll_bytes = 0.0
        self.kinds: dict[str, list] = {}
        self.ops: set[str] = set()
        self.by_op: dict[str, float] = {}
        self.scale = 1  # iterations each op stands for (`repeat`)

    def __enter__(self):
        self._outer = getattr(_ACTIVE, "census", None)
        _ACTIVE.census = self
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.census = self._outer
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor issues the local ops: seen next
        out = func(*args, **kwargs)
        ins = _tensors(args, kwargs.values())
        if not any(isinstance(t, FakeTensor) for t in ins):
            self._count(func, args, ins,
                        _tensors(out if isinstance(out, (list, tuple))
                                 else (out,)))
        return out

    def _count(self, func, args, ins: list, outs: list) -> None:
        name = func.overloadpacket.__name__
        op = str(func.overloadpacket)
        self.ops.add(op)
        flops = nbytes = 0.0
        out_bytes = sum(_nbytes(t) for t in outs)
        if name in _SLICE_UPDATE:
            i = _SLICE_UPDATE[name]
            upd = args[i] if i < len(args) else None
            if isinstance(upd, torch.Tensor):
                nbytes = 2 * _nbytes(upd)
        elif not (func.is_view or name in _BOOKKEEPING):
            nbytes = out_bytes

        if name in _MATMUL:
            a = ins[1] if name.startswith("add") or name == "baddbmm" else ins[0]
            flops = 2.0 * outs[0].numel() * a.shape[-1]
            if name.startswith("add") or name == "baddbmm":
                flops += outs[0].numel()  # the bias add
        elif name == "convolution":
            w = ins[1]
            flops = (2.0 * outs[0].numel() * w.shape[1]
                     * math.prod(w.shape[2:]))
        elif name in _ELEMENTWISE or name in _REDUCE:
            flops = outs[0].numel() if outs else 0
        elif name in ("_softmax", "_log_softmax"):
            # XLA's lowering: max and sum reductions over the rows, then
            # subtract, exponential, divide (or log, subtract) per element
            rows = outs[0].numel() // max(outs[0].shape[args[1]], 1)
            flops = 3 * outs[0].numel() + 2 * rows
        times = self.scale
        self.bytes += nbytes * times
        if flops:
            self.flops += flops * times
            self.by_op[op] = self.by_op.get(op, 0.0) + flops * times

        kind = _KIND.get(name)
        if kind is not None:
            n = _group_size(name, args)
            if kind == "collective-permute":
                w = float(out_bytes)
            else:
                w = out_bytes * _COLLECTIVES[kind] * (n - 1) / n if n > 1 else 0.0
            self.coll_bytes += w * times
            k = self.kinds.setdefault(kind, [0, 0.0])
            k[0] += times
            k[1] += w * times

    def report(self, entry: str) -> dict:
        return {
            "entry": entry,
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": self.coll_bytes,
            "collectives_by_kind": {k: {"count": v[0], "weighted_bytes": v[1]}
                                    for k, v in self.kinds.items()},
            "n_computations": len(self.ops),
            "flops_by_op": dict(sorted(self.by_op.items(),
                                       key=lambda kv: -kv[1])),
        }


def trace(fn, *args, **kwargs) -> tuple:
    """(fn's output, the census of its run): `fn(*args, **kwargs)` once
    under the census."""
    with _Census() as census:
        out = fn(*args, **kwargs)
    return out, census.report(getattr(fn, "__name__", type(fn).__name__))


def analyze(fn, *args, **kwargs) -> dict:
    """The per-device census of `fn(*args, **kwargs)`: the JAX census's
    keys (`entry`, `flops`, `bytes`, `collective_bytes`,
    `collectives_by_kind` with `count` and `weighted_bytes`, and
    `n_computations`, here the number of distinct aten ops), and
    `flops_by_op`: the FLOPs of each aten op, largest first."""
    return trace(fn, *args, **kwargs)[1]
