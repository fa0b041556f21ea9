"""CodedSystem: one session handle over the encode AND decode stacks.

The paper treats encoding and repair as two faces of one decentralized
system — decode is scheduled *as* an all-to-all encode among survivors —
and applications continually move between healthy encodes and degraded
reads.  `CodedSystem` owns both planners, the shared host-table cache and
the live erasure state:

    from repro_torch.api import CodeSpec, CodedSystem

    system = CodedSystem(CodeSpec(kind="rs", K=16, R=4), backend="local")
    cw = system.codeword(x)        # [x | parity] systematic codeword (N, W)
    system.fail([2, 17])           # processors 2 and 17 go dark
    x2 = system.read(cw)           # degraded read — auto-replanned decode
    cw = system.rebuild(cw)        # re-materialize lost symbols + heal()

Underneath, `Encoder.plan` / `Decoder.plan` remain the public planner
layer this composes; decode plans are re-planned automatically whenever
the erasure pattern changes (and cached per pattern via the Decoder's
LRU), and every execution runs on the registered `Backend` the session was
opened with, on the session's torch device ("cuda" unless `device=` says
otherwise).  Streaming, the coding queue (`submit`), `stats()` and
`describe()` are not ported yet (ROADMAP queue 1, item 5).

Payload conventions (mirroring the planners):

  * `encode(x)` takes the (K, W) data block, returns (R, W) parity.
  * `decode(v)` / `read(v)` accept EITHER the full (N, W) codeword
    row-stack (rows at failed positions are ignored) OR the (K, W)
    survivor symbols ordered like `system.kept` — the leading dimension
    disambiguates (N = K + R > K always).
  * 1-D inputs are treated as W = 1 and squeezed on return.
  * numpy int64 in, numpy int64 out; on the device payloads are int32.

Thread safety: erasure-state transitions (`fail`/`heal`) are
lock-protected.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any

import numpy as np

from .planner import ALPHA_DEFAULT, BETA_BITS_DEFAULT, EncodePlan, Encoder
from .registry import resolve_device
from .spec import CodeSpec


@dataclass(frozen=True)
class LinkModel:
    """The paper's linear link-cost model C = alpha*C1 + beta_bits*C2.

    alpha     — per-round latency in seconds (Table I's alpha)
    beta_bits — seconds per field element per port, i.e. beta * ceil(log2 q)
    """

    alpha: float = ALPHA_DEFAULT
    beta_bits: float = BETA_BITS_DEFAULT

    def __post_init__(self):
        if self.alpha < 0 or self.beta_bits < 0:
            raise ValueError(
                f"LinkModel needs alpha >= 0 and beta_bits >= 0, got "
                f"alpha={self.alpha!r}, beta_bits={self.beta_bits!r}")

    def us(self, cost: Any) -> float:
        """Model microseconds of an analytic `LinearCost` (anything with
        `.total(alpha, beta_bits)`)."""
        return cost.total(self.alpha, self.beta_bits) * 1e6


class CodedSystem:
    """Session handle: spec + backend + device + live erasure state (see
    module docstring for the scenario).

    Parameters
    ----------
    spec    : the `CodeSpec` (what code, what system shape)
    backend : registered backend name ("local" built in); capability-
              checked at construction
    method  : encode schedule ("auto" = Table-I cost-model argmin)
    A       : explicit generator block (kind="universal"/"lagrange")
    link    : `LinkModel` (or `repro_torch.topo.TieredLinkModel`) for
              auto selection
    topology: a `repro_torch.topo.Topology` or explicit `Placement`
    placement: the policy a bare `topology` is placed with — "affinity"
              (default) or "flat"
    trace   : observability tracer — True (collect, read
              `system.tracer`), an `obs.trace.Tracer`, or a path (trace
              JSON written there on `close()`); kernel launches and
              host<->device copies land on it as spans
    device  : torch device for every plan of the session; None means
              "cuda", and a missing card raises RuntimeError (pass
              device="cpu" for the kernels' plain versions)
    """

    def __init__(self, spec: CodeSpec, backend: str = "local", *,
                 method: str = "auto", A: np.ndarray | None = None,
                 link: Any = None, topology: Any = None,
                 placement: str = "affinity", trace=None, device=None):
        self.spec = spec
        self.backend = backend
        self.device = resolve_device(device)
        self.link = link or LinkModel()
        self._A = A
        self.topology = None
        self._placement = None
        if topology is not None:
            from ..topo import Placement, Topology, n_procs, place

            if isinstance(topology, Placement):
                self._placement, self.topology = topology, topology.topology
            elif isinstance(topology, Topology):
                self.topology = topology
                if topology.n_slots >= n_procs(spec):
                    self._placement = place(spec, topology, placement)
            else:
                raise TypeError(
                    f"topology must be a Topology or Placement, "
                    f"got {type(topology).__name__}")
        from ..obs import trace as _trace_mod

        self.tracer, self._trace_path = _trace_mod.resolve(trace)
        if self.tracer is not None:
            _trace_mod.install(self.tracer)
        # eager plan: all capability checks + host-table builds happen now
        self._enc: EncodePlan = Encoder.plan(
            spec, backend=backend, method=method, A=A,
            topology=self._placement if self._placement is not None
            else self.topology,
            link=self.link if topology is not None else None,
            device=self.device)
        self._failed: set[int] = set()
        self._dplan: Any = None          # decode plan for current pattern
        self._lock = threading.RLock()

    # -- plans --------------------------------------------------------------
    @property
    def encode_plan(self) -> EncodePlan:
        """The live `EncodePlan` (the still-public planner layer)."""
        return self._enc

    @property
    def placement(self):
        """The resolved `repro_torch.topo.Placement` (None without a topology or
        when the topology has fewer slots than processors)."""
        return self._placement

    @property
    def decode_plan(self):
        """The `DecodePlan` for the CURRENT erasure pattern — re-planned
        on pattern change, cached per pattern (Decoder LRU + this handle).
        Raises `UndecodableError` for information-losing patterns
        (possible only for the non-MDS dft codeword)."""
        with self._lock:
            pattern = tuple(sorted(self._failed))
            if self._dplan is None or self._dplan.erased != pattern:
                from ..recover import Decoder

                self._dplan = Decoder.plan(self.spec, erased=pattern,
                                           backend=self.backend, A=self._A,
                                           device=self.device)
            return self._dplan

    # -- erasure state ------------------------------------------------------
    @property
    def failed(self) -> tuple[int, ...]:
        """Sorted codeword positions currently failed (data k < K, parity
        K + r)."""
        with self._lock:
            return tuple(sorted(self._failed))

    @property
    def kept(self) -> tuple[int, ...]:
        """The K survivor positions reads consume, in input-row order
        (simply 0..K-1 while the system is healthy)."""
        if not self.failed:
            return tuple(range(self.spec.K))
        return self.decode_plan.kept

    def fail(self, procs) -> "CodedSystem":
        """Mark processors failed (int or iterable of codeword positions).
        Cumulative; at most R total — beyond that no code can help, so the
        transition is refused rather than discovered at read time."""
        if isinstance(procs, (int, np.integer)):
            procs = (procs,)
        procs = {int(e) for e in procs}
        bad = [e for e in procs if not 0 <= e < self.spec.N]
        if bad:
            raise ValueError(
                f"positions {bad} outside the codeword [0, {self.spec.N})")
        with self._lock:
            new = self._failed | procs
            if len(new) > self.spec.R:
                raise ValueError(
                    f"{len(new)} failures exceed the code's R="
                    f"{self.spec.R} (currently failed: "
                    f"{sorted(self._failed)})")
            self._failed = new
        return self

    def heal(self, procs=None) -> "CodedSystem":
        """Mark processors recovered (default: all of them).  Positions
        are validated like `fail`'s — a typo'd heal must not silently
        leave the system degraded."""
        with self._lock:
            if procs is None:
                self._failed.clear()
                return self
            if isinstance(procs, (int, np.integer)):
                procs = (procs,)
            procs = {int(e) for e in procs}
            bad = [e for e in procs if not 0 <= e < self.spec.N]
            if bad:
                raise ValueError(
                    f"positions {bad} outside the codeword "
                    f"[0, {self.spec.N})")
            self._failed -= procs
        return self

    # -- encode -------------------------------------------------------------
    def encode(self, x) -> np.ndarray:
        """Encode data x (K,)/(K, W) -> parity (R,)/(R, W)."""
        return self._enc.run(x)

    def codeword(self, x) -> np.ndarray:
        """The full systematic codeword [x | parity]: (K, W) -> (N, W)."""
        x = np.asarray(x)
        parity = self._enc.run(x)
        data = (x % self.spec.q).astype(np.int64)
        return np.concatenate([data, parity], axis=0)

    # -- decode / degraded read ---------------------------------------------
    def _survivor_view(self, v, plan) -> np.ndarray:
        """Normalize (N, ...) codeword rows or (K, ...) kept-ordered
        survivor symbols to the (K, ...) form `plan` consumes.  The plan
        is passed in (not re-resolved from the live erasure state) so one
        operation slices and executes against ONE pattern even if a
        concurrent `fail`/`heal` lands mid-flight."""
        v = np.asarray(v)
        if v.shape[0] == self.spec.N:
            return v[list(plan.kept)]
        if v.shape[0] == self.spec.K:
            return v
        raise ValueError(
            f"expected the full (N={self.spec.N}, ...) codeword or the "
            f"(K={self.spec.K}, ...) survivor symbols of system.kept, got "
            f"leading dim {v.shape[0]}")

    def decode(self, v) -> np.ndarray:
        """Recompute the symbols at the failed positions from survivors:
        returns (|failed|,)/(|failed|, W) rows ordered like
        `system.failed` (empty while healthy)."""
        plan = self.decode_plan  # pinned: one pattern for slice + run
        return plan.run(self._survivor_view(v, plan))

    def read(self, v) -> np.ndarray:
        """Degraded read: the full original data (K,)/(K, W) from the
        survivors.  Healthy systems read the data rows directly; with
        failures this runs the cached decode plan's data path."""
        v = np.asarray(v)
        if not self.failed:
            if v.shape[0] not in (self.spec.N, self.spec.K):
                raise ValueError(
                    f"expected (N={self.spec.N}, ...) or (K={self.spec.K},"
                    f" ...) rows, got leading dim {v.shape[0]}")
            return (v[: self.spec.K] % self.spec.q).astype(np.int64)
        plan = self.decode_plan  # pinned: one pattern for slice + data
        return plan.data(self._survivor_view(v, plan))

    # -- rebuild: re-materialize the full codeword, then heal ---------------
    def _complement_plan(self, plan):
        """Decode plan for every position OUTSIDE `plan.kept` — the failed
        positions plus the unkept survivors (exactly N - K = R targets).
        A (K, W) kept-ordered payload has no rows for any of them, so a
        rebuild from survivors-only input recomputes them all.  Always
        decodable when `plan` itself was: the kept set is a basis."""
        comp = tuple(i for i in range(self.spec.N)
                     if i not in set(plan.kept))
        from ..recover import Decoder

        return Decoder.plan(self.spec, erased=comp, backend=self.backend,
                            A=self._A, device=self.device)

    def rebuild(self, v) -> np.ndarray:
        """Recompute ALL currently-failed symbols from the survivors,
        `heal()` the session, and return the fully healed (N,)/(N, W)
        codeword — the decentralized re-materialization step that restores
        full redundancy after failures (decode-as-encode among survivors;
        bitwise-identical across backends).

        `v` is the full (N, ...) codeword (rows at failed positions
        ignored) or the (K, ...) survivor symbols ordered like
        `system.kept` — with K rows the unkept survivor rows are
        recomputed too (complement-pattern decode).  Only the pattern
        pinned at entry is healed: a concurrent `fail` landing mid-rebuild
        stays failed."""
        plan = self.decode_plan  # pin ONE pattern for slice + run + heal
        v = np.asarray(v)
        squeeze = v.ndim == 1
        healed = self._rebuild_block(v[:, None] if squeeze else v, plan)
        self.heal(plan.erased)
        return healed[:, 0] if squeeze else healed

    def _rebuild_block(self, v: np.ndarray, plan) -> np.ndarray:
        """One (N, w) healed block from an (N, w)/(K, w) survivor block
        (the non-streamed body of `rebuild`; pattern pinned by `plan`)."""
        N, K, q = self.spec.N, self.spec.K, self.spec.q
        if v.shape[0] == N:
            healed = (v % q).astype(np.int64)
            if plan.erased:
                healed[list(plan.erased)] = plan.run(v[list(plan.kept)])
            return healed
        if v.shape[0] == K:
            comp = self._complement_plan(plan)
            healed = np.empty((N, v.shape[1]), np.int64)
            healed[list(comp.kept)] = (v % q).astype(np.int64)
            healed[list(comp.erased)] = comp.run(v)
            return healed
        raise ValueError(
            f"expected the full (N={N}, ...) codeword or the (K={K}, ...) "
            f"survivor symbols of system.kept, got leading dim {v.shape[0]}")

    # -- lifecycle ----------------------------------------------------------
    def close(self) -> None:
        """Uninstall the session's tracer (saving it when `trace=` was a
        path).  The session stays usable."""
        if self.tracer is not None:
            from ..obs import trace as _trace_mod

            _trace_mod.uninstall(self.tracer)
            if self._trace_path is not None:
                self.tracer.save(self._trace_path)
                self._trace_path = None  # idempotent close()

    def __enter__(self) -> "CodedSystem":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
