"""Backend protocol + registry: the single dispatch surface behind BOTH
planners (`Encoder`/`EncodePlan` and `recover.Decoder`/`DecodePlan`).

A *backend* is an executor for planned encodes/decodes.  The port's three
built-ins (registered in `api.backends`) are interchangeable and
bitwise-identical to the JAX package's backends of the same names:

    local     — single-device CUDA kernels (NTT fast path / dense field
                matmul; no communication schedule) on the plan's device
    simulator — the paper's p-port round network (exact numpy oracle on
                the host; measured C1/C2 on `plan.last_stats` /
                `plan.sim_net`)
    mesh      — the paper's decentralized rounds on a processor mesh: each
                rank of the process group owns K/G processors on its one
                device (the JAX package puts one device on each processor)

Third-party / experimental executors plug in without touching core:

    from repro_torch.api import Backend, register_backend

    @register_backend("mybackend")
    class MyBackend(Backend):
        def encode(self, plan, x):      # (K, w) -> (R, w) int64 mod q
            ...
        def decode(self, plan, v):      # (K, w) -> (|E|, w) int64 mod q
            ...

    plan = Encoder.plan(spec, backend="mybackend")

The session lays out codewords and rebuilt blocks through
`Backend.run_into`, whose default composes `encode` / `decode` with the
host's layout; a backend may override it to lay them out where it computes
them (the local backend does, on the device).  A `supports_stream`
backend gives `api.stream` its device program (`stream_program`), and
`describe_line` adds the backend's own line to `plan.describe()`; the
session and the planners never ask which backend they run on.

Capabilities are *declared* up front — `supports_stream`,
`measures_network`, `host_only`, `supports_field(q)`,
`device_requirement(spec)` — and
checked once at plan time (`Backend.validate`), so an unsupported
(spec, backend) pair fails with a `BackendCapabilityError` naming the
mismatch instead of a deep kernel assert mid-run.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

from ..core.cost_model import LinearCost
from ..obs import drift as _drift
from ..obs.metrics import REGISTRY as _METRICS
from ..obs.trace import host_span

if TYPE_CHECKING:
    from .spec import CodeSpec

# the registry families every network-measuring run publishes into
# (module-level handles: zero name lookup on the hot path)
_RUNS = _METRICS.counter("coded_runs_total",
                         "plan executions on network-measuring backends")
_ROUNDS = _METRICS.counter("sim_rounds_total",
                           "simulator rounds executed (sum of C1)")
_C2_ELEMS = _METRICS.counter("sim_c2_elems_total",
                             "simulator max-message traffic (sum of C2)")


class BackendCapabilityError(ValueError):
    """The (spec, backend) pair is unsupported: raised at plan time by
    `Backend.validate` with the capability that failed (field modulus,
    device count, grid shape, ranks), never from inside a kernel."""


@dataclass(frozen=True)
class RunStats:
    """Measured network cost of ONE plan execution (simulator backend):
    exact C1 (rounds) and C2 (field elements per port) of that run."""

    C1: int
    C2: int
    backend: str = "simulator"
    op: str = "encode"

    def total(self, alpha: float, beta_bits: float) -> float:
        """Evaluate the linear link-cost model on the measured counts —
        same contract (and implementation) as `LinearCost.total`."""
        return LinearCost(self.C1, self.C2).total(alpha, beta_bits)


class Backend:
    """Protocol for a plan executor.  Subclass, implement `encode` /
    `decode`, and register under a name (see module docstring).

    Declared capabilities (override as needed):

      supports_stream   — the backend provides a device pipeline for
                          `plan.run_stream` (`stream_program`; built-in:
                          local, mesh).
                          Backends without it still stream correctly via
                          per-chunk `encode`/`decode` calls.
      measures_network  — runs yield exact (C1, C2) network stats,
                          recorded thread-locally on `plan.last_stats`.
      host_only         — runs touch no device (the simulator): plans on
                          it resolve no torch device (`plan_device`).
      supports_field(q) — which moduli the executor handles (the CUDA
                          kernels are Fermat-only).
      device_requirement(spec) — CUDA devices each rank needs to run plans
                          of `spec` on the card (mesh: one, `cuda:local_rank`;
                          the JAX package counts one per processor).  It is
                          checked where CUDA is present; a plan on
                          `device="cpu"` needs none, and a CUDA plan without
                          CUDA fails in `resolve_device`.
    """

    name: str = "?"
    supports_stream: bool = False
    measures_network: bool = False
    host_only: bool = False
    # optional one-line reason shown in the unsupported-field error
    # (set by backends whose supports_field is restrictive)
    field_note: str | None = None

    def supports_field(self, q: int) -> bool:
        return True

    def device_requirement(self, spec: "CodeSpec") -> int:
        return 0

    def validate(self, spec: "CodeSpec", op: str = "encode") -> None:
        """Plan-time capability gate; raises `BackendCapabilityError`."""
        if not self.supports_field(spec.q):
            note = f" ({self.field_note})" if self.field_note else ""
            raise BackendCapabilityError(
                f"backend {self.name!r} does not support q={spec.q} for "
                f"{op} of kind={spec.kind!r}{note}; backend='simulator' "
                "runs any prime modulus")
        need = self.device_requirement(spec)
        if need:
            import torch

            have = torch.cuda.device_count()
            if torch.cuda.is_available() and have < need:
                raise BackendCapabilityError(
                    f"backend {self.name!r} needs >= {need} CUDA devices "
                    f"for K={spec.K}, found {have}")

    # -- execution ----------------------------------------------------------
    def encode(self, plan, x):
        """Execute an `EncodePlan`: (K, w) payload -> (R, w) sink values,
        int64 mod q, bitwise-equal to x^T A."""
        raise BackendCapabilityError(
            f"backend {self.name!r} does not implement encode")

    def decode(self, plan, v):
        """Execute a `DecodePlan`: (K, w) survivor symbols (ordered like
        `plan.kept`) -> (|E|, w) repaired symbols, int64 mod q."""
        raise BackendCapabilityError(
            f"backend {self.name!r} does not implement decode")

    def run_into(self, plan, v, pick=None, into=None):
        """Run `plan` (encode or decode, `plan.op`) on the rows `pick` of the
        (k, w) payload v (None: all of them) and lay the answer out by
        `into`: None, the plan's rows; or (n, rows), n int64 rows holding
        v's residues mod q in the first len(v) and the plan's rows at
        `rows` (a systematic codeword: (N, range(K, N)); a rebuilt one:
        (N, erased)) — `api.backends.run_on_device`'s contract.  This
        default runs `encode` / `decode` and lays the rows out on the host
        (`api.backends.host_layout`), as the session's "gather",
        "residues" and "assemble" spans; the local backend does both on
        the device."""
        from .backends import host_layout

        picked = v
        if pick is not None:
            with host_span("gather", "session"):
                picked = v[list(pick)]
        run = self.encode if plan.op == "encode" else self.decode
        y = run(plan, picked)
        del picked
        if into is None:
            return y
        return host_layout(into[0], plan.field.q, v, rows=y, rows_at=into[1],
                           track="session")

    def stream_program(self, plan):
        """A `supports_stream` backend's device pipeline for `plan`
        (`api.stream`): the per-chunk function, (k, w) int32 rows on
        `plan.device` -> the plan's (R, w) / (|E|, w) int32 rows, and the
        payload rows this rank copies to its device (None: all)."""
        raise BackendCapabilityError(
            f"backend {self.name!r} has no device pipeline")

    def describe_line(self, plan) -> str | None:
        """The backend's own last line of `plan.describe()`, or None."""
        return None


def resolve_device(device=None):
    """The `torch.device` a plan runs on: "cuda" when `device` is None.
    Raises RuntimeError when that is a CUDA device and CUDA is absent — a
    port entry point never carries on quietly on the CPU; pass
    device="cpu" to ask for it."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run the plain versions of the kernels")
        if dev.index is None:  # one cache key per physical card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def plan_device(backend: str, device=None):
    """The device of a plan on `backend`: None for a host-only backend (the
    simulator touches no device, so `device` is moot there and never
    resolved), `resolve_device(device)` otherwise."""
    if get_backend(backend).host_only:
        return None
    return resolve_device(device)


_REGISTRY: dict[str, Backend] = {}


def register_backend(name: str, backend: Backend | type | None = None, *,
                     overwrite: bool = False):
    """Register an executor under `name` (usable as a class decorator).

    `backend` may be a `Backend` subclass (instantiated here) or an
    instance.  Re-registering a taken name raises unless `overwrite=True`
    (third-party code must not silently shadow the built-ins).
    """

    def _register(obj):
        be = obj() if isinstance(obj, type) else obj
        if name in _REGISTRY and not overwrite:
            raise ValueError(
                f"backend {name!r} is already registered "
                "(pass overwrite=True to replace it)")
        be.name = name
        _REGISTRY[name] = be
        return obj

    return _register if backend is None else _register(backend)


def unregister_backend(name: str) -> None:
    """Remove a registered backend (no-op if absent).  Plans already
    created for it keep their `backend` name and will fail on next run."""
    _REGISTRY.pop(name, None)


def available_backends() -> tuple[str, ...]:
    """Names of all registered backends (built-ins first)."""
    return tuple(_REGISTRY)


def get_backend(name: str) -> Backend:
    """The registered executor, or ValueError naming the known ones."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered backends: "
            f"{tuple(_REGISTRY)}") from None


class PlanStats:
    """Thread-local run statistics, mixed into both plan classes.

    Plans are cached and shared across callers *and threads*; writing
    measured stats onto the plan object directly would let concurrent
    `run()` calls clobber each other (the old `plan.sim_net` race).
    Instead every run records into a `threading.local`, so each thread
    reads the stats of ITS OWN last run on this plan:

        last_stats   — `RunStats` of the last run on this thread
                       (simulator backend; None otherwise)
        sim_net      — the full `RoundNetwork` of that run (round-by-round
                       inspection; None on kernel backends)
        stream_stats — `StreamStats` of the last `run_stream` consumed on
                       this thread

    THREAD-LOCAL CONTRACT: these properties answer only for the calling
    thread.  A thread that has not run this plan reads `None` — never
    another thread's stats, no matter how recently that other thread ran
    (so a queue worker's measurements are invisible to the submitting
    thread; use the obs registry / drift ledger for cross-thread
    aggregates).  This is a guarantee, not a limitation: it is what makes
    `plan.last_stats` race-free on shared cached plans, and it is pinned
    by a regression test (`test_obs.py::test_plan_stats_cross_thread`).

    Every `_record_net` additionally publishes into the process-wide
    `obs.metrics.REGISTRY` (run/round/traffic counters) and — when the
    caller passes the run's payload `width` — checks the measured (C1, C2)
    against the closed-form cost model via `obs.drift.LEDGER`.
    """

    @property
    def last_stats(self) -> RunStats | None:
        return getattr(self._tls, "stats", None)

    @property
    def sim_net(self):
        return getattr(self._tls, "net", None)

    @property
    def stream_stats(self):
        return getattr(self._tls, "stream_stats", None)

    @stream_stats.setter
    def stream_stats(self, value) -> None:
        self._tls.stream_stats = value

    def _record_net(self, net, op: str, width: int | None = None) -> None:
        self._tls.net = net
        self._tls.stats = RunStats(net.C1, net.C2, backend=self.backend,
                                   op=op)
        kind = self.spec.kind
        _RUNS.inc(1, backend=self.backend, op=op, kind=kind)
        _ROUNDS.inc(net.C1, backend=self.backend, op=op, kind=kind)
        _C2_ELEMS.inc(net.C2, backend=self.backend, op=op, kind=kind)
        if width is not None:
            _drift.record_run(self, net, op, width)
