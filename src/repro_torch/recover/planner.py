"""Decoder: the decode/repair planner, mirroring `repro_torch.api.Encoder`.

    spec = CodeSpec(kind="rs", K=16, R=4)
    plan = Decoder.plan(spec, erased=(2, 17), backend="local")
    lost = plan.run(v)        # v: (K, W) symbols at plan.kept -> (|E|, W)
    x    = plan.data(v)       # full original data (K, W)

The systematic codeword of a spec is [x | EncodePlan.run(x)] — data symbol
k lives on processor k, parity symbol r on processor K + r.  `erased` is a
set of codeword positions in [0, K + R); `plan.run` recomputes exactly the
erased symbols from the K survivors `plan.kept` (chosen greedily as the
first survivor positions whose generator columns are linearly independent
— for MDS kinds that is simply the first K survivors; the DFT transform's
[I | A] is *not* MDS, and a pattern whose survivors span less than the
full message space raises `UndecodableError`).

Like the encoder, everything host-side happens once at plan time and is
cached: the survivor submatrix inverse S^-1, the repair matrix
D = S^-1 G[:, E] (numpy, exact), the decode schedule IR and the mesh
tables of each repair batch, and per plan their copies on the device.
Three backends return bitwise-identical symbols:

    simulator — all-to-all decode among the survivors on a RoundNetwork
                with the erased processors `fail()`-ed (measured C1/C2 on
                `plan.sim_net`; host only)
    mesh      — survivors as processors of the mesh, one universal mesh
                all-to-all per repair batch (`recover.backends`)
    local     — single-device `decode_blocks` (the `gf_matmul` kernel)

`repair_with_faults` restarts a simulator repair against the enlarged
erasure set when processors die mid-schedule.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field as dc_field
from typing import Any

import numpy as np
import torch

from ..api.backends import run_on_device
from ..api.planner import ALPHA_DEFAULT, BETA_BITS_DEFAULT, _digest, _host_tables
from ..api.registry import PlanStats, get_backend, plan_device
from ..api.spec import CodeSpec
from ..core.cost_model import LinearCost
from ..core.field import FERMAT_Q, Field
from ..core.matrices import gauss_inverse
from ..core.simulator import PartialRunError, RoundNetwork
from ..obs.trace import host_span
from .engine import batch_block, decode_batches, decode_cost


class UndecodableError(ValueError):
    """The erasure pattern is information-losing: a nonzero codeword is
    supported entirely on the erased positions (only possible for non-MDS
    kinds, e.g. the DFT transform's [I | A] codeword)."""


def _choose_kept(field: Field, G: np.ndarray, survivors: list[int], K: int) -> tuple[int, ...]:
    """First K survivor positions with linearly independent generator
    columns (greedy Gaussian elimination over F_q)."""
    basis: list[tuple[int, np.ndarray]] = []  # (pivot row, normalized col)
    kept: list[int] = []
    for s in survivors:
        vec = G[:, s] % field.q
        for piv, r in basis:
            if vec[piv]:
                vec = (vec - vec[piv] * r) % field.q
        nz = np.nonzero(vec)[0]
        if nz.size == 0:
            continue
        piv = int(nz[0])
        basis.append((piv, (vec * int(field.inv(vec[piv]))) % field.q))
        kept.append(s)
        if len(kept) == K:
            return tuple(kept)
    raise UndecodableError(
        f"survivors span a {len(kept)}-dimensional space < K={K}: the "
        "erasure pattern is undecodable for this (non-MDS) code")


# ---------------------------------------------------------------------------
# host-side decode tables (cached per spec x erasure pattern, W-independent)
# ---------------------------------------------------------------------------

@dataclass
class DecodeTables:
    """Everything host-side a decode plan needs, built once per
    (spec, erased) and shared across backends, devices and payload widths."""

    spec: CodeSpec
    field: Field
    erased: tuple[int, ...]      # sorted codeword positions, |E| <= R
    kept: tuple[int, ...]        # the K chosen survivor positions
    D: np.ndarray                # (K, |E|) repair matrix  S^-1 G[:, E]
    Dd: np.ndarray               # (K, K)  data matrix     S^-1
    _ir: Any = None              # lazy core.schedule.RoundIR
    _mesh: dict = dc_field(default_factory=dict)  # batch -> mesh tables

    def ir(self):
        """The decode `core.schedule.RoundIR` among the kept survivors,
        built and `validate()`d (against the erasure set) once per table
        set — the simulator executes exactly this program."""
        if self._ir is None:
            from ..core.schedule import build_decode_ir

            self._ir = build_decode_ir(
                self.spec, self.D, list(self.kept)).validate(
                    failed=set(self.erased))
        return self._ir

    def batches(self) -> list[tuple[int, int]]:
        return decode_batches(self.spec.K, len(self.erased))

    def batch_block(self, b: int) -> np.ndarray:
        """Zero-padded (K, E') column block of D for batch b (the same
        blocks the simulator schedule runs — see `engine.batch_block`)."""
        return batch_block(self.D, b)

    def mesh_tables(self, b: int):
        """`core.parity.ParityTables` for batch b's universal mesh
        all-to-all, built once."""
        if b not in self._mesh:
            from ..core.parity import build_encode_tables

            self._mesh[b] = build_encode_tables(
                self.field, self.batch_block(b), p=self.spec.p,
                method="universal")
        return self._mesh[b]


# Unlike the encoder's caches (keyed by a handful of specs), decode keys
# range over erasure *patterns* — a combinatorial space on a long-running
# server that decodes around ever-changing failure sets — so both caches
# are LRU-bounded instead of unbounded dicts.
_DTABLES: "OrderedDict[tuple, DecodeTables]" = OrderedDict()
_DPLANS: "OrderedDict[tuple, DecodePlan]" = OrderedDict()
_DTABLES_MAX = 256
_DPLANS_MAX = 512
_DSTATS = {"table_hits": 0, "table_misses": 0,
           "plan_hits": 0, "plan_misses": 0}


def _lru_get(cache: OrderedDict, key):
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
    return hit


def _lru_put(cache: OrderedDict, key, value, maxsize: int) -> None:
    cache[key] = value
    while len(cache) > maxsize:
        cache.popitem(last=False)


def _decode_tables(spec: CodeSpec, erased: tuple[int, ...],
                   A: np.ndarray | None, digest: str | None) -> DecodeTables:
    key = spec.table_key() + (digest, erased)
    hit = _lru_get(_DTABLES, key)
    if hit is not None:
        _DSTATS["table_hits"] += 1
        return hit
    _DSTATS["table_misses"] += 1
    host = _host_tables(spec, A, digest)   # shares the Encoder's table cache
    f = host.field
    K = spec.K
    G = np.concatenate([np.eye(K, dtype=np.int64), host.A % f.q], axis=1)
    survivors = [i for i in range(spec.N) if i not in set(erased)]
    with host_span("kept", "planner"):
        kept = _choose_kept(f, G, survivors, K)
    with host_span("inverse", "planner"):
        inv_sub = gauss_inverse(f, G[:, list(kept)])
    with host_span("repair", "planner"):
        D = f.matmul(inv_sub, G[:, list(erased)])
    tables = DecodeTables(spec, f, erased, kept, D, inv_sub)
    _lru_put(_DTABLES, key, tables, _DTABLES_MAX)
    return tables


# ---------------------------------------------------------------------------
# DecodePlan
# ---------------------------------------------------------------------------

@dataclass
class DecodePlan(PlanStats):
    """An executable erasure decode: spec + erasure pattern + backend +
    cached host tables + the device it runs on.  Obtained from
    `Decoder.plan`; cached — hold on to it and call `.run` per payload.

    Per-run measurements (`last_stats`, `sim_net`, `stream_stats`) are
    thread-local (see `api.registry.PlanStats`): plans are shared across
    threads and each thread reads only its own last run.
    """

    op = "decode"  # stream/backend dispatch discriminator (not a field)

    spec: CodeSpec
    backend: str
    tables: DecodeTables
    device: Any = None           # torch.device (None: host-only backend)
    _local_fn: Any = None
    _mesh_fns: list | None = None
    _Dd: Any = None              # lazy device copy of tables.Dd (int32)
    # thread-local per-run stats storage (PlanStats reads/writes this)
    _tls: Any = dc_field(default_factory=threading.local, repr=False)

    @property
    def field(self) -> Field:
        return self.tables.field

    @property
    def erased(self) -> tuple[int, ...]:
        """Sorted erased codeword positions; `run` returns their symbols."""
        return self.tables.erased

    @property
    def kept(self) -> tuple[int, ...]:
        """The K survivor positions whose symbols `run`/`data` consume,
        in input-row order."""
        return self.tables.kept

    @property
    def survivors(self) -> tuple[int, ...]:
        """All non-erased codeword positions."""
        dead = set(self.tables.erased)
        return tuple(i for i in range(self.spec.N) if i not in dead)

    @property
    def D(self) -> np.ndarray:
        """(K, |E|) repair matrix: erased symbols are v^T D per column."""
        return self.tables.D

    def _check(self, v, pick=None) -> tuple[np.ndarray, bool]:
        v = np.asarray(v)
        if (v.shape[0] if pick is None else len(pick)) != self.spec.K:
            raise ValueError(
                f"v must carry the K={self.spec.K} survivor symbols of "
                f"plan.kept along its leading dim, got {v.shape}")
        return (v[:, None], True) if v.ndim == 1 else (v, False)

    def run(self, v) -> np.ndarray:
        """Recompute the erased symbols: v (K,)/(K, W) survivor symbols
        ordered like `plan.kept` -> (|E|,)/(|E|, W) repaired symbols
        ordered like `plan.erased`."""
        v, squeeze = self._check(v)
        if not self.erased:
            y = np.zeros((0, v.shape[1]), np.int64)
        else:
            y = get_backend(self.backend).decode(self, v)
        return y[:, 0] if squeeze else y

    def run_stream(self, payload, *, chunk_w: int | None = None):
        """Streamed repair: generator of (|E|, w) blocks of recomputed
        symbols; same chunking/pipelining/bitwise contract as
        `EncodePlan.run_stream` (see api/stream.py).  `payload` carries the
        K survivor symbols of `plan.kept` along its leading dim."""
        from ..api import stream

        if not self.erased:
            def _zeros():
                cw = chunk_w or stream.plan_chunk_w(self)
                for c in stream.iter_chunks(payload, self.spec.K, cw):
                    yield np.zeros((0, c.shape[1]), np.int64)
            return _zeros()
        return stream.run_stream(self, payload, chunk_w=chunk_w)

    def run_batched(self, vs, *, chunk_w: int | None = None) -> list[np.ndarray]:
        """Repair a batch of survivor payloads (each (K,) or (K, W_i)) in
        one coalesced streamed execution."""
        from ..api import stream

        if not self.erased:
            return [np.zeros((0,) + np.asarray(v).shape[1:], np.int64)
                    for v in vs]
        return stream.run_batched(self, vs, chunk_w=chunk_w)

    # -- streaming adapter (see api/stream.py) ------------------------------
    def _stream_sim_chunk(self, v: np.ndarray):
        from .backends import run_simulator

        return run_simulator(self, v)  # (y, RoundNetwork) pair

    def _stream_device_fn(self):
        """The per-chunk device function of the pipeline: (K, w) int32 ->
        (|E|, w) int32 on `plan.device` ((K/G, w), this rank's block, on
        the mesh)."""
        from .backends import local_decode_callable, mesh_decode_fn

        if self.backend == "mesh":
            return mesh_decode_fn(self)
        return local_decode_callable(self)

    def _stream_rows(self) -> slice | None:
        """The survivor rows this rank copies to its device (the mesh
        block), or None for all."""
        if self.backend != "mesh":
            return None
        from .backends import _mesh_callables

        return _mesh_callables(self)[0].mesh.block

    def data(self, v, pick=None) -> np.ndarray:
        """Decode the full original data x (K, W) from the survivors (the
        degraded-read path).  Runs the `gf_matmul` kernel with S^-1 on the
        plan's device for the Fermat field, the exact host matmul otherwise
        and on a host-only (simulator) plan — bitwise identical.  `pick`:
        the K rows of v that hold the survivors of `plan.kept`, picked on
        the device where it runs (None: v is those rows)."""
        v, squeeze = self._check(v, pick)
        f = self.field
        if f.q == FERMAT_Q and self.device is not None:
            from ..kernels.ops import decode_blocks

            if self._Dd is None:
                self._Dd = torch.as_tensor(
                    (self.tables.Dd % f.q).astype(np.int32),
                    device=self.device)
            Dd = self._Dd
            x = run_on_device(lambda vd: decode_blocks(vd, Dd), v, f.q,
                              self.device, "local_data", pick=pick,
                              kind=self.spec.kind, K=self.spec.K)
        else:
            x = f.matmul(self.tables.Dd.T,
                         v if pick is None else v[list(pick)])
        return x[:, 0] if squeeze else x

    def cost(self) -> LinearCost:
        """Closed-form (C1, C2) of the round-network decode schedule, with
        the spec's payload width W folded into C2 (Encoder convention)."""
        c = decode_cost(self.spec.K, len(self.erased), self.spec.p)
        return LinearCost(c.C1, c.C2 * self.spec.W)

    def schedule_ir(self):
        """The decode `core.schedule.RoundIR` this plan's simulator path
        executes (shared, via the tables, across backends/widths)."""
        return self.tables.ir()

    def describe(self) -> str:
        s = self.spec
        c = self.cost()
        model_us = c.total(ALPHA_DEFAULT, BETA_BITS_DEFAULT) * 1e6
        batches = self.tables.batches()
        sched = (self.schedule_ir().summary() if self.erased
                 else "empty (nothing erased)")
        lines = [
            f"DecodePlan[{s.kind}] K={s.K} R={s.R} p={s.p} W={s.W} q={s.q}",
            f"  backend : {self.backend}",
            f"  erased  : {list(self.erased)} ({len(self.erased)} of <= {s.R})",
            f"  kept    : {list(self.kept)}",
            f"  batches : {batches} (width, padded to divisor of K)",
            f"  cost    : C1={c.C1} rounds, C2={c.C2} elems/port "
            f"(model C ~ {model_us:.1f} us)",
            f"  schedule: {sched}",
        ]
        if self.backend == "mesh":
            from ..api.planner import mesh_note

            lines.append(f"  mesh    : {mesh_note(self)}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# live-failure repair: restart the decode against the enlarged erasure set
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RepairAttempt:
    """One (re)planned decode attempt inside `repair_with_faults`: the
    pattern it targeted, the exact rounds/traffic it consumed on the shared
    network (for an aborted attempt, the completed prefix only), and — when
    aborted — the processors whose mid-run death enlarged the pattern."""

    erased: tuple[int, ...]
    C1: int
    C2: int
    completed: bool
    killed: tuple[int, ...] = ()


@dataclass
class RepairReport:
    """Result of `repair_with_faults`: the fully healed codeword, the plan
    of the final (largest) erasure pattern, the network whose cumulative
    C1/C2 account every aborted prefix plus the successful retry exactly
    (`net.C1 == sum(a.C1 for a in attempts)`, and the last attempt's C1
    equals the closed-form `decode_cost`), and the per-attempt trace."""

    codeword: np.ndarray
    plan: "DecodePlan"
    net: RoundNetwork
    attempts: list[RepairAttempt]

    @property
    def erased(self) -> tuple[int, ...]:
        """The final erasure pattern the repair recomputed."""
        return self.plan.erased

    @property
    def restarts(self) -> int:
        return sum(1 for a in self.attempts if not a.completed)


def repair_with_faults(spec: CodeSpec, cw, erased=(), *,
                       net: RoundNetwork | None = None,
                       A: np.ndarray | None = None) -> RepairReport:
    """Repair `erased` on the round network under live failure injection.

    Runs the decode-as-encode schedule among the survivors of `erased` on
    `net` (a fresh `RoundNetwork(spec.N, spec.p)` by default — pass one
    with `fail_at` kills registered, e.g. via `core.FaultInjector`, to
    inject chaos).  When a kill lands mid-schedule, the resulting
    `PartialRunError` is caught, the erasure set enlarged by the newly
    dead processors, and the repair *restarted* against the superset
    pattern on the SAME network — so `net.C1`/`net.C2` account the aborted
    prefix plus the retry exactly.  A kill that hits an idle survivor
    (one the schedule never touches) still loses that symbol: a follow-up
    pass recomputes it before returning.

    `cw` is the full (N, W) (or (N,)) codeword; rows at erased positions
    are ignored.  Returns a `RepairReport` whose `codeword` is the fully
    healed (N, W) — bitwise-equal to the original for any total failure
    count <= R (beyond R, `Decoder.plan` refuses with the usual
    `ValueError`; information-losing dft patterns raise
    `UndecodableError`).  Runs on the simulator: host only, no device.
    """
    cw = np.asarray(cw)
    squeeze = cw.ndim == 1
    v2 = cw[:, None] if squeeze else cw
    if v2.shape[0] != spec.N:
        raise ValueError(
            f"cw must carry the full N={spec.N} codeword rows, got "
            f"{cw.shape}")
    net = net or RoundNetwork(spec.N, spec.p)
    net.fail({int(e) for e in erased})
    attempts: list[RepairAttempt] = []
    while True:
        # a kill due exactly at this round boundary enlarges the pattern
        # BEFORE planning (it would abort the very first round otherwise)
        net.apply_pending_kills()
        pattern = tuple(sorted(net.failed))
        plan = Decoder.plan(spec, erased=pattern, backend="simulator", A=A)
        c1_0, c2_0 = net.C1, net.C2
        f = plan.field
        v = f.arr(v2[list(plan.kept)])
        try:
            from ..core import schedule

            y = schedule.execute(plan.schedule_ir(), f, v, net)
        except PartialRunError as exc:
            attempts.append(RepairAttempt(
                pattern, net.C1 - c1_0, net.C2 - c2_0, completed=False,
                killed=tuple(sorted(set(exc.failed) - set(pattern)))))
            continue
        attempts.append(RepairAttempt(
            pattern, net.C1 - c1_0, net.C2 - c2_0, completed=True))
        if net.failed - set(pattern):
            # an idle survivor died mid-run without aborting the schedule;
            # its symbol is lost all the same — repair the superset too
            continue
        healed = (v2 % spec.q).astype(np.int64)
        if pattern:
            healed[list(pattern)] = np.asarray(y, np.int64)
        return RepairReport(healed[:, 0] if squeeze else healed, plan, net,
                            attempts)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class Decoder:
    """Namespace for the decode plan-then-execute API (all classmethods)."""

    ALPHA = ALPHA_DEFAULT
    BETA_BITS = BETA_BITS_DEFAULT

    @classmethod
    def plan(cls, spec: CodeSpec, erased, backend: str = "local",
             A: np.ndarray | None = None, *, device=None) -> DecodePlan:
        """Plan a decode of the given erasure pattern.

        erased : iterable of codeword positions in [0, K + R); data symbol
                 k is position k, parity symbol r is position K + r.
                 At most R positions may be erased.
        backend: a registered backend name ("local" | "simulator" |
                 "mesh" built in; see `api.register_backend`),
                 capability-checked here
        A      : explicit generator block for kind="universal"/"lagrange"
                 specs — must match the block the data was encoded with.
        device : the torch device the plan runs on; None means "cuda",
                 and a missing card then raises RuntimeError.  Moot (the
                 plan's is None) on the host-only simulator backend.
        """
        get_backend(backend).validate(spec, op="decode")
        device = plan_device(backend, device)
        erased = tuple(sorted({int(e) for e in erased}))
        if erased and not (0 <= erased[0] and erased[-1] < spec.N):
            raise ValueError(
                f"erased positions must lie in [0, {spec.N}), got {erased}")
        if len(erased) > spec.R:
            raise ValueError(
                f"{len(erased)} erasures exceed the code's R={spec.R}")
        with host_span("plan", "planner", erased=len(erased)) as span:
            digest = _digest(A)
            plan_key = (spec, erased, backend, digest, device)
            hit = _lru_get(_DPLANS, plan_key)
            span["hit"] = hit is not None
            if hit is not None:
                _DSTATS["plan_hits"] += 1
                return hit
            _DSTATS["plan_misses"] += 1
            tables = _decode_tables(spec, erased, A, digest)
            plan = DecodePlan(spec, backend, tables, device=device)
            _lru_put(_DPLANS, plan_key, plan, _DPLANS_MAX)
            return plan

    @classmethod
    def cache_info(cls) -> dict[str, int]:
        return dict(_DSTATS, plans=len(_DPLANS), tables=len(_DTABLES))

    @classmethod
    def cache_clear(cls) -> None:
        """Drop the decode-side caches (plans + decode tables); for a
        coordinated clear of both stacks use `repro_torch.api.cache_clear()`."""
        _clear_decoder_state()


def _clear_decoder_state() -> None:
    _DPLANS.clear()
    _DTABLES.clear()
    for k in _DSTATS:
        _DSTATS[k] = 0
