"""The three built-in executors behind `EncodePlan.run`, registered on the
`api.registry` Backend protocol.

    simulator — the round-based `RoundNetwork` lockstep engine (exact numpy
                oracle on the host; measured C1/C2 recorded thread-locally
                on `plan.last_stats` / `plan.sim_net`).  It touches no
                device, so a simulator plan's `device` is None.
    mesh      — the paper's decentralized rounds on a processor mesh
                (`core.shardmap_exec.ProcMesh`): each rank of the process
                group (one rank without a group) owns a contiguous block of
                K/G processors on its device; a round is an index copy
                inside the block plus one `batch_isend_irecv` across ranks;
                the per-processor combine is the batched `gf_matmul` kernel;
                sinks overlay processors 0..R-1
    local     — single-device encode on the plan's torch device: the NTT
                fast path (`kernels.ntt_encode`, the `ntt` CUDA kernels) or
                the dense `kernels.ops.encode_blocks` field matmul (the
                `gf_matmul` CUDA kernel); no communication schedule at all

All three return the JAX package's sink values bitwise: sink r holds
x^T A[:, r] over F_q.  Inputs/outputs are numpy int64 (K, W) -> (R, W); on
the device the kernels take int32 residues (`run_on_device`).  The decode
halves live in `recover.backends`; the `Backend` objects below bind both.

With G > 1 ranks the mesh is SPMD: every rank calls the same entry point
with the same payload, copies its own block of it to its device, and gets
the same numpy result (the output blocks are all-gathered).
"""
from __future__ import annotations

import sys
import threading
from collections import OrderedDict

import numpy as np
import torch

from ..core import schedule
from ..core.field import FERMAT_Q
from ..core.simulator import RoundNetwork
from ..obs.trace import kernel_span
from .registry import Backend, BackendCapabilityError, register_backend


def run_simulator(plan, x: np.ndarray) -> tuple[np.ndarray, RoundNetwork]:
    """Execute the plan on the paper's p-port round network; returns
    (sink values, the network with its measured C1/C2).

    All four kinds run through one path: the plan's schedule IR
    (`plan.schedule_ir()` — the canonical builder output, or the
    `tier_commute`-rewritten program for `commute=True` plans) executed
    generically by `core.schedule.execute`."""
    spec, f = plan.spec, plan.field
    x = f.arr(x)
    pl = getattr(plan, "placement", None)
    ir = plan.schedule_ir()
    net = RoundNetwork(ir.n_procs, spec.p, placement=pl)
    y = schedule.execute(ir, f, x, net)
    return np.asarray(y, np.int64), net


_DEVICE_DTYPES = (np.dtype(np.int64), np.dtype(np.int32))


def _index(rows, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.int64), device=device)


def _to_device(xh: torch.Tensor, device) -> torch.Tensor:
    """A copy of host tensor `xh` on `device`.  To a CUDA device it goes
    through a pinned block of torch's caching host allocator: every host
    thread copies into it and the DMA runs at the link's rate, where a
    pageable copy runs at the pace of CUDA's one staging thread."""
    if torch.device(device).type != "cuda":
        return xh.to(device, copy=True)
    pinned = torch.empty(xh.shape, dtype=xh.dtype, pin_memory=True)
    pinned.copy_(xh)
    return pinned.to(device)


def _held(arrays: list, i: int) -> bool:
    """Whether anything but the list `arrays` refers to `arrays[i]`: a name,
    a NumPy view (whose `base` it is), a tensor of `torch.from_numpy`, an
    exported buffer.  Exact in CPython, where an array that the list alone
    holds counts two references here: the list's and the argument's."""
    return sys.getrefcount(arrays[i]) > 2


class AnswerPool:
    """The int64 answers `run_on_device` hands out, handed out again once
    their callers have let go of them, so that the widening writes pages
    already faulted in instead of a fresh block's.

    `take` hands out, of the arrays it tracks for the shape, the one handed
    out last that nothing outside the pool holds (`_held`).  When every one
    is held it allocates a new array and tracks it, and stops tracking the
    one handed out longest ago: that array is its holder's alone from then
    on, so answers a caller keeps drop out of the pool.  A caller that lets
    each answer go before the next call reuses one array; one that holds
    the last answer while it asks for the next, two in turn.

    Bound: at most `PER_SHAPE` arrays for each of the `SHAPES` shapes asked
    for last; when a shape falls out, its free arrays go back to the
    allocator.  A weak reference does not hold an answer."""

    SHAPES = 4
    PER_SHAPE = 2

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_shape: OrderedDict[tuple, list] = OrderedDict()

    def take(self, shape) -> tuple[np.ndarray, bool]:
        """(a C-contiguous int64 array of `shape` that nothing but the pool
        holds, whether it was tracked before).  Its contents are stale."""
        shape = tuple(int(n) for n in shape)
        with self._lock:
            arrays = self._by_shape.pop(shape, [])
            self._by_shape[shape] = arrays
            if len(self._by_shape) > self.SHAPES:
                self._by_shape.popitem(last=False)
            for i in reversed(range(len(arrays))):
                if not _held(arrays, i):
                    arrays.append(arrays.pop(i))
                    return arrays[-1], True
            if len(arrays) == self.PER_SHAPE:
                del arrays[0]
            arrays.append(np.empty(shape, np.int64))
            return arrays[-1], False

    def tracked(self) -> dict:
        """{shape: arrays tracked}, shapes from the one asked for longest ago."""
        with self._lock:
            return {s: len(a) for s, a in self._by_shape.items()}


ANSWERS = AnswerPool()


def run_on_device(fn, x: np.ndarray, q: int, device, name: str, *,
                  pick=None, into=None, **span_args) -> np.ndarray:
    """numpy payload -> `fn` on `device` -> a numpy int64 answer the caller
    owns.

    An int64 or int32 payload goes to the device as it is and its residues
    mod q are taken there; any other dtype is reduced to int32 on the host
    first (the "host_in" span's `on_card` arg says which).  `fn` maps
    (k, w) int32 residues to its rows.  On the device
      pick : the rows of x that `fn` reads (None: all of them);
      into : None, the answer is `fn`'s rows; or (n, rows), the answer is n
             rows holding x's residues in the first len(x) and `fn`'s rows
             at `rows` (a systematic codeword: (N, range(K, N)); a rebuilt
             one: (N, erased)).
    On a CUDA device both copies go through pinned blocks of torch's
    caching host allocator.  The int32 answer is widened on the host into
    an int64 array from `ANSWERS` (on every device): one that an earlier
    call handed out and its caller has let go of, its pages already
    faulted in, or else a new one.  Either way it is C-contiguous,
    writeable and owns its data, every element is written, and it shares
    memory with nothing the caller holds.  The pool keeps at most two
    arrays for each of the four shapes asked for last (`AnswerPool`).

    Each leg is its own `kernel_span`, so a trace splits an operation into
    host work ("host_in": the payload as a tensor; "host_out": the
    widening, its arg `reused` true where the answer came from the pool),
    the copies ("h2d", "d2h"), the device's own glue ("residues_dev":
    residues and picked rows; "place_dev": `fn`'s rows into the answer)
    and the kernels (`name`)."""
    x = np.asarray(x)
    on_card = x.dtype in _DEVICE_DTYPES
    with kernel_span("host_in", on_card=on_card):
        if not on_card:
            x = np.ascontiguousarray(x % q, dtype=np.int32)
        elif min(x.strides, default=0) < 0:  # torch takes no negative stride
            x = np.ascontiguousarray(x)
        xh = torch.from_numpy(x)
    with kernel_span("h2d", bytes=xh.nbytes):
        xd = _to_device(xh, device)  # ours to reduce in place
    with kernel_span("residues_dev"):
        if into is None:
            if pick is not None:
                xd = xd.index_select(0, _index(pick, device))
            xr = xd.remainder_(q).to(torch.int32,
                                     memory_format=torch.contiguous_format)
        else:
            buf = torch.empty((into[0],) + tuple(xd.shape[1:]),
                              dtype=torch.int32, device=device)
            xr = buf[:xd.shape[0]]
            xr.copy_(xd.remainder_(q))
            if pick is not None:
                xr = xr.index_select(0, _index(pick, device))
        del xd
    with kernel_span(name, w=int(xr.shape[1]), **span_args):
        y = fn(xr)
    if into is not None:
        with kernel_span("place_dev"):
            y = buf.index_copy_(0, _index(into[1], device), y)
    with kernel_span("d2h", bytes=y.numel() * y.element_size()):
        if y.is_cuda:
            yh = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            yh.copy_(y)
        else:
            yh = y
    with kernel_span("host_out") as span:
        out, span["reused"] = ANSWERS.take(y.shape)
        torch.from_numpy(out).copy_(yh)
        del xh, xr, y, yh
    return out


def local_encode_callable(plan):
    """The plan's local-encode function (K, w) int32 -> (R, w) int32 on
    `plan.device`, built once and cached on the plan.

    The planner auto-selects the O(K log K) NTT fast path
    (`kernels.ntt_encode`) for dft and structured rs/lagrange specs when
    their point sets are radix-2 single cosets (in particular, K a power
    of two); otherwise this is the dense `encode_blocks` field matmul with
    the generator block kept on the device.  Both are exact mod-q
    arithmetic, so the choice is bitwise-invisible.
    """
    if plan._local_fn is None:
        params = plan.tables.ntt_params()
        if params is not None:
            from ..kernels.ntt_encode import ntt_encode

            def fn(x):
                return ntt_encode(x, params)
        else:
            from ..kernels.ops import encode_blocks

            A = torch.as_tensor((plan.A % plan.field.q).astype(np.int32),
                                device=plan.device)

            def fn(x):
                return encode_blocks(x, A)
        plan._local_fn = fn
    return plan._local_fn


def run_local(plan, x: np.ndarray, into=None) -> np.ndarray:
    """Single-device encode on the kernel path (no network): the cached
    NTT fast path or dense field matmul, per the planner.  `into` places
    the parity in a larger answer on the device (`run_on_device`)."""
    return run_on_device(local_encode_callable(plan), x, plan.field.q,
                         plan.device, f"local_encode.{plan.local_impl}",
                         into=into, kind=plan.spec.kind, K=plan.spec.K)


def _mesh_axes(plan):
    """The plan's `TieredAxis` — a (hosts x K/hosts) split of the
    processors when the plan carries a multi-host topology whose host count
    divides K — or None for the flat mesh.  It classifies the legs
    (`ProcMesh.legs`); the processor layout and outputs are the same."""
    from ..core.shardmap_exec import TieredAxis

    topo = getattr(plan, "topology", None)
    K = plan.spec.K
    if topo is not None and 1 < topo.hosts <= K and K % topo.hosts == 0:
        return TieredAxis(topo.hosts, K // topo.hosts)
    return None


def build_mesh_callable(plan):
    """The plan's mesh program (a `core.shardmap_exec.MeshStep`): this
    rank's (K/G, w) int32 block on `plan.device` -> the (R, w) sink values
    ((K, w) for dft), gathered from every rank."""
    from ..core import shardmap_exec as se
    from ..core.parity import mesh_parity_encode

    spec = plan.spec
    mesh = se.ProcMesh(spec.K, plan.device, tiered=_mesh_axes(plan))

    if spec.kind == "dft":
        t = plan.tables.dft_mesh_tables()
        ca, cb = mesh.rows(t.ca.T), mesh.rows(t.cb.T)
        return se.MeshStep(mesh, lambda xb: se.mesh_dft(xb, ca, cb, t, mesh),
                           spec.K)

    if spec.K % spec.R != 0:
        raise BackendCapabilityError(
            f"mesh backend covers the R | K grid (Sec. III-A); got "
            f"K={spec.K}, R={spec.R}")

    if getattr(plan, "commute", False):
        # a tier_commute-rewritten schedule no longer matches the
        # hand-built table path: lower its IR generically (per-round
        # permutation legs + combine layers, see core.shardmap_exec)
        dev_of = list(range(spec.K)) + list(range(spec.R))  # sink K+r -> r
        prog = se.build_ir_mesh_program(plan.schedule_ir(), dev_of)
        rows = se.ir_rows(prog, mesh)
        return se.MeshStep(
            mesh, lambda xb: se.mesh_ir_encode(xb, rows, prog, mesh), spec.R)

    t = plan.tables.mesh_tables(plan.method)
    rows = t.device_rows(mesh)
    return se.MeshStep(
        mesh, lambda xb: mesh_parity_encode(xb, rows, t, mesh), spec.R)


def run_mesh(plan, x: np.ndarray) -> np.ndarray:
    """Encode on the processor mesh: this rank's block of x goes to its
    device, the sink rows come back from every rank."""
    fn = plan.mesh_callable()
    return run_on_device(fn, np.asarray(x)[fn.mesh.block], plan.field.q,
                         plan.device, "mesh_encode", kind=plan.spec.kind,
                         K=plan.spec.K)


# ---------------------------------------------------------------------------
# the built-in Backend registrations (encode halves above, decode halves in
# recover.backends — imported lazily to keep the api <-> recover import DAG
# acyclic)
# ---------------------------------------------------------------------------


@register_backend("simulator")
class SimulatorBackend(Backend):
    """Exact lockstep oracle on the paper's p-port round network, on the
    host.  Runs any prime modulus; the only backend that measures network
    cost (exact C1/C2 recorded thread-locally on
    `plan.last_stats`/`plan.sim_net`).  Host-only: its plans carry no
    device."""

    measures_network = True
    host_only = True

    def encode(self, plan, x):
        y, net = run_simulator(plan, x)
        plan._record_net(net, op="encode", width=x.shape[1])
        return y

    def decode(self, plan, v):
        from ..recover.backends import run_simulator as run_dec

        y, net = run_dec(plan, v)
        plan._record_net(net, op="decode", width=v.shape[1])
        return y


@register_backend("local")
class LocalBackend(Backend):
    """Single-device kernel path (NTT fast path / dense field matmul) on the
    plan's torch device.  No communication schedule; Fermat arithmetic
    only.  `supports_stream`: `plan.run_stream` runs the device pipeline of
    `api.stream` (copy stream, pinned buffers, events) on a CUDA plan."""

    supports_stream = True
    field_note = f"the CUDA kernels are Fermat-only, q={FERMAT_Q}"

    def supports_field(self, q: int) -> bool:
        return q == FERMAT_Q

    def encode(self, plan, x):
        return run_local(plan, x)

    def decode(self, plan, v):
        from ..recover.backends import run_local as run_dec

        return run_dec(plan, v)


@register_backend("mesh")
class MeshBackend(Backend):
    """The paper's decentralized rounds on a processor mesh: each rank owns
    K/G processors on its device (G = 1 on one card), rounds are index
    copies inside a rank and `batch_isend_irecv` across ranks.  Fermat
    only; encode additionally needs the R | K framework grid (Sec. III-A)
    for non-dft kinds, and K must split evenly over the ranks.
    `supports_stream`: `plan.run_stream` runs the device pipeline of
    `api.stream` over the mesh program."""

    supports_stream = True
    field_note = f"the CUDA kernels are Fermat-only, q={FERMAT_Q}"

    def supports_field(self, q: int) -> bool:
        return q == FERMAT_Q

    def device_requirement(self, spec) -> int:
        return 1  # per rank: cuda:local_rank, or device="cpu"

    def validate(self, spec, op: str = "encode") -> None:
        from ..core.shardmap_exec import world

        # structural mismatches first: they hold on any device count
        if op == "encode" and spec.kind != "dft" and spec.K % spec.R != 0:
            raise BackendCapabilityError(
                f"mesh encode covers the R | K framework grid (Sec. III-A); "
                f"got K={spec.K}, R={spec.R} — use backend='simulator' or "
                "'local' for this spec")
        G = world()[0]
        if spec.K % G:
            raise BackendCapabilityError(
                f"mesh backend splits K={spec.K} processors over the {G} "
                f"ranks of the process group in equal blocks: K % G must "
                "be 0")
        super().validate(spec, op)

    def encode(self, plan, x):
        return run_mesh(plan, x)

    def decode(self, plan, v):
        from ..recover.backends import run_mesh as run_dec

        return run_dec(plan, v)
