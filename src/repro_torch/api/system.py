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
layer this composes: `system.encode_plan` and `system.decode_plan` expose
the live plans, decode plans are re-planned automatically whenever the
erasure pattern changes (and cached per pattern via the Decoder's LRU),
and every execution runs on the registered `Backend` the session was
opened with, on the session's torch device ("cuda" unless `device=` says
otherwise; the host-only simulator has none).  `encode_stream`/
`decode_stream`/`rebuild_stream`/`encode_batched` run the streaming engine
(`api.stream`: on the card, a copy stream, pinned buffers and events
overlap each chunk's transfer with the previous chunk's kernels), and
`system.submit(...)` returns futures through a lazily started
`CodingQueue` that coalesces concurrent requests into batched streamed
executions.  `stats()` and `describe()` report the whole selection.

The port's default backend is "local" (the card); the JAX package's is
"simulator".

Payload conventions (mirroring the planners):

  * `encode(x)` takes the (K, W) data block, returns (R, W) parity.
  * `decode(v)` / `read(v)` accept EITHER the full (N, W) codeword
    row-stack (rows at failed positions are ignored) OR the (K, W)
    survivor symbols ordered like `system.kept` — the leading dimension
    disambiguates (N = K + R > K always).
  * 1-D inputs are treated as W = 1 and squeezed on return.
  * numpy int64 in, numpy int64 out; on the device the kernels take int32
    residues, taken there from int64 or int32 payloads.

Thread safety: erasure-state transitions (`fail`/`heal`) and queue
lifecycle are lock-protected; per-run measured stats are thread-local on
the plans (`plan.last_stats`), surfaced through `system.stats()`.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Iterable, Iterator

import numpy as np

from ..obs.trace import host_span
from .planner import ALPHA_DEFAULT, BETA_BITS_DEFAULT, EncodePlan, Encoder
from .registry import get_backend, plan_device
from .spec import CodeSpec


@dataclass(frozen=True)
class LinkModel:
    """The paper's linear link-cost model C = alpha*C1 + beta_bits*C2.

    alpha     — per-round latency in seconds (Table I's alpha)
    beta_bits — seconds per field element per port, i.e. beta * ceil(log2 q)

    Used by the system for cost reporting (`stats()`/`describe()`); the
    defaults are the constants the demos and benchmarks report with.
    """

    alpha: float = ALPHA_DEFAULT
    beta_bits: float = BETA_BITS_DEFAULT

    def __post_init__(self):
        if self.alpha < 0 or self.beta_bits < 0:
            raise ValueError(
                f"LinkModel needs alpha >= 0 and beta_bits >= 0, got "
                f"alpha={self.alpha!r}, beta_bits={self.beta_bits!r}")

    def us(self, cost: Any) -> float:
        """Model microseconds of an analytic `LinearCost` or a measured
        `RunStats` (anything with `.total(alpha, beta_bits)` — a
        `topo.TieredCost` collapses to its flat sum here)."""
        return cost.total(self.alpha, self.beta_bits) * 1e6


class CodedSystem:
    """Session handle: spec + backend + device + live erasure state (see
    module docstring for the scenario).

    Parameters
    ----------
    spec    : the `CodeSpec` (what code, what system shape)
    backend : registered backend name ("local" | "simulator" built in);
              capability-checked at construction.  The default is "local"
              (the card), where the JAX package's is "simulator".
    method  : encode schedule ("auto" = Table-I cost-model argmin; under a
              topology + `TieredLinkModel` the argmin prices each method's
              per-tier split)
    A       : explicit generator block (kind="universal"/"lagrange")
    link    : `LinkModel` (or `repro_torch.topo.TieredLinkModel`) for cost
              reporting and auto selection
    chunk_w : default streaming chunk width for `*_stream`/queue paths
              (None: `api.stream.plan_chunk_w`)
    topology: a `repro_torch.topo.Topology` or explicit `Placement` — the
              simulator then measures exact per-tier C1/C2 (surfaced in
              `stats()["encode"]["tiers"]` and the drift ledger)
    placement: the policy a bare `topology` is placed with — "affinity"
              (default) or "flat"
    commute : apply the `RoundIR.tier_commute` schedule rewrite under the
              resolved placement (required); see
              `Encoder.plan(commute=...)`
    queue   : an externally-owned `launch.coding_queue.CodingQueue` to
              route `submit` futures through instead of a lazily-opened
              private one (many sessions sharing one queue coalesce
              same-plan requests; `close()` never closes a queue the
              session does not own).  Must run the session's backend on
              the session's device.
    trace   : observability tracer — True (collect, read
              `system.tracer`), an `obs.trace.Tracer`, or a path (trace
              JSON written there on `close()`); simulator rounds, the
              session's and the decode planner's host steps, stream
              pipeline stages, kernel launches and host<->device copies
              land on it as spans
    device  : torch device for every plan of the session; None means
              "cuda", and a missing card raises RuntimeError (pass
              device="cpu" for the kernels' plain versions).  Moot on the
              host-only simulator backend (`system.device` is None there).
    """

    def __init__(self, spec: CodeSpec, backend: str = "local", *,
                 method: str = "auto", A: np.ndarray | None = None,
                 link: Any = None, chunk_w: int | None = None,
                 topology: Any = None, placement: str = "affinity",
                 commute: bool = False, queue: Any = None, trace=None,
                 device=None):
        self.spec = spec
        self.backend = backend
        self.device = plan_device(backend, device)
        self.link = link or LinkModel()
        self.chunk_w = chunk_w
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

        if queue is not None and (queue.backend != backend
                                  or queue.device != self.device):
            raise ValueError(
                f"shared queue runs backend {queue.backend!r} on "
                f"{queue.device} but the session was opened on {backend!r} "
                f"on {self.device} — a queued submission would silently "
                "execute elsewhere")
        if commute and self._placement is None:
            raise ValueError(
                "commute=True needs a placed topology (pass a Topology "
                "with enough slots, or an explicit Placement) — the "
                "tier_commute rewrite is placement-aware")
        self.tracer, self._trace_path = _trace_mod.resolve(trace)
        if self.tracer is not None:
            _trace_mod.install(self.tracer)
        self._shared_queue = queue
        # eager plan: all capability checks + host-table builds happen now
        self._enc: EncodePlan = Encoder.plan(
            spec, backend=backend, method=method, A=A,
            topology=self._placement if self._placement is not None
            else self.topology,
            link=self.link if topology is not None else None,
            commute=commute, device=self.device)
        self._failed: set[int] = set()
        self._dplan: Any = None          # decode plan for current pattern
        self._queue: Any = None
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
        """The full systematic codeword [x | parity]: (K, W) -> (N, W).  On
        the local backend the device places x's residues and the parity in
        one (N, W) answer; elsewhere the host concatenates them."""
        x = np.asarray(x)
        K, N = self.spec.K, self.spec.N
        if self.backend == "local" and x.ndim in (1, 2) and x.shape[0] == K:
            from .backends import run_local

            with host_span("assemble", "session"):
                into = (N, range(K, N))
            cw = run_local(self._enc, x[:, None] if x.ndim == 1 else x, into)
            return cw[:, 0] if x.ndim == 1 else cw
        parity = self._enc.run(x)
        with host_span("residues", "session"):
            data = (x % self.spec.q).astype(np.int64)
        with host_span("assemble", "session"):
            cw = np.concatenate([data, parity], axis=0)
            del data, parity  # the parts' pages are released in the span
        return cw

    def encode_stream(self, payload, *, chunk_w: int | None = None
                      ) -> Iterator[np.ndarray]:
        """Streamed encode: generator of (R, w) parity blocks (see
        `EncodePlan.run_stream`)."""
        return self._enc.run_stream(payload, chunk_w=chunk_w or self.chunk_w)

    def encode_batched(self, xs, *, chunk_w: int | None = None
                       ) -> list[np.ndarray]:
        """Encode a batch of payloads in one coalesced streamed run."""
        return self._enc.run_batched(xs, chunk_w=chunk_w or self.chunk_w)

    # -- decode / degraded read ---------------------------------------------
    def _survivor_view(self, v, plan) -> np.ndarray:
        """Normalize (N, ...) codeword rows or (K, ...) kept-ordered
        survivor symbols to the (K, ...) form `plan` consumes.  The plan
        is passed in (not re-resolved from the live erasure state) so one
        operation slices and executes against ONE pattern even if a
        concurrent `fail`/`heal` lands mid-flight."""
        v = np.asarray(v)
        if v.shape[0] == self.spec.N:
            with host_span("gather", "session"):
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
            with host_span("residues", "session"):
                return (v[: self.spec.K] % self.spec.q).astype(np.int64)
        plan = self.decode_plan  # pinned: one pattern for slice + data
        if v.shape[0] == self.spec.N and plan.device is not None:
            with host_span("assemble", "session"):
                pick = plan.kept  # the device picks the survivor rows
            return plan.data(v, pick)
        return plan.data(self._survivor_view(v, plan))

    def decode_stream(self, payload, *, chunk_w: int | None = None
                      ) -> Iterator[np.ndarray]:
        """Streamed repair: generator of (|failed|, w) blocks.  `payload`
        is a (N, W)/(K, W) array or an iterable of such chunks (each
        sliced to survivors as needed).  The erasure pattern is pinned
        when the stream is created; later `fail`/`heal` calls do not
        affect chunks already in flight."""
        plan = self.decode_plan
        pieces: Iterable = ((payload,) if hasattr(payload, "shape")
                            else payload)

        def _sliced():
            for piece in pieces:
                yield self._survivor_view(piece, plan)

        return plan.run_stream(_sliced(), chunk_w=chunk_w or self.chunk_w)

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
        (the non-streamed body of `rebuild`; pattern pinned by `plan`).
        The repaired rows are computed first and scattered after, so the
        session's host spans and the device call's legs never nest."""
        N, K, q = self.spec.N, self.spec.K, self.spec.q
        if v.shape[0] == N:
            fill = list(plan.erased)
            if fill and self.backend == "local":
                from ..recover.backends import run_local

                with host_span("assemble", "session"):
                    pick, into = plan.kept, (N, fill)
                return run_local(plan, v, pick, into)
            if fill:
                with host_span("gather", "session"):
                    kept = v[list(plan.kept)]
                rows = plan.run(kept)
                del kept
            with host_span("residues", "session"):
                healed = (v % q).astype(np.int64)
            if fill:
                with host_span("assemble", "session"):
                    healed[fill] = rows
                    del rows
            return healed
        if v.shape[0] == K:
            comp = self._complement_plan(plan)
            rows = comp.run(v)
            with host_span("residues", "session"):
                data = (v % q).astype(np.int64)
            with host_span("assemble", "session"):
                healed = np.empty((N, v.shape[1]), np.int64)
                healed[list(comp.kept)] = data
                healed[list(comp.erased)] = rows
                del data, rows
            return healed
        raise ValueError(
            f"expected the full (N={N}, ...) codeword or the (K={K}, ...) "
            f"survivor symbols of system.kept, got leading dim {v.shape[0]}")

    def rebuild_stream(self, payload, *, chunk_w: int | None = None
                       ) -> Iterator[np.ndarray]:
        """Streamed rebuild: generator of fully-healed (N, w) codeword
        chunks.  `payload` is a (N, W)/(K, W) array or an iterable of such
        chunks; the repaired rows run through the plan's streaming engine
        (the device pipeline on the card) while the survivor rows ride
        along as passthrough.  The erasure pattern is pinned at creation;
        the session is healed (of that pattern) once the stream is
        exhausted."""
        from . import stream as stream_mod

        plan = self.decode_plan  # pin ONE pattern for the whole stream
        cw = (chunk_w or self.chunk_w or stream_mod.plan_chunk_w(plan))
        N, K, q = self.spec.N, self.spec.K, self.spec.q

        def _gen():
            import itertools

            split = stream_mod.split_chunks(payload, cw)
            first = next(split, None)
            if first is None:
                self.heal(plan.erased)
                return
            rows = first.shape[0]
            chunks = itertools.chain((first,), split)
            if rows == N:
                dplan = plan
                kept_idx = list(plan.kept)
                fill = list(plan.erased)

                def slice_fn(c):
                    return c[kept_idx]

                def assemble(c, y):
                    healed = (c % q).astype(np.int64)
                    if fill:
                        healed[fill] = y
                    return healed
            elif rows == K:
                dplan = self._complement_plan(plan)
                kept_idx, comp_idx = list(dplan.kept), list(dplan.erased)

                def slice_fn(c):
                    return c

                def assemble(c, y):
                    healed = np.empty((N, c.shape[1]), np.int64)
                    healed[kept_idx] = (c % q).astype(np.int64)
                    healed[comp_idx] = y
                    return healed
            else:
                raise ValueError(
                    f"rebuild_stream chunks must carry N={N} codeword rows "
                    f"or the K={K} kept survivor rows, got {rows}")
            for c, y in stream_mod.run_paired_stream(dplan, chunks, slice_fn,
                                                     chunk_w=cw):
                yield assemble(c, y)
            self.heal(plan.erased)

        return _gen()

    # -- batched submission (coding queue) ----------------------------------
    def _ensure_queue(self):
        if self._shared_queue is not None:
            return self._shared_queue
        with self._lock:
            if self._queue is None:
                from ..launch.coding_queue import CodingQueue

                self._queue = CodingQueue(backend=self.backend,
                                          chunk_w=self.chunk_w,
                                          device=self.device)
            return self._queue

    def submit(self, op: str, payload, *, meta=None):
        """Submit an "encode", "decode", or "rebuild" request; returns a
        `concurrent.futures.Future`.  Requests are coalesced with other
        in-flight submissions sharing the same plan into single batched
        streamed executions (`launch.coding_queue.CodingQueue`).

        Decode/rebuild submissions pin the erasure pattern at submit time,
        with *failover*: if a later `fail()` invalidates the pinned
        pattern before the request is executed (the new pattern is a
        strict superset), the queue transparently replans against the
        superset — survivors that died after submission are never
        consumed.  A decode future still resolves to the rows of the
        pattern it was submitted for; a rebuild future resolves to the
        fully healed (N, W) codeword (the session is NOT auto-healed).
        Failover needs the full (N, ...) payload to re-slice; rebuild
        requires it outright, and a (K, ...) decode payload whose pattern
        is invalidated fails its future rather than decode stale rows."""
        if op == "encode":
            return self._ensure_queue().submit_encode(self.spec, payload,
                                                      A=self._A, meta=meta)
        if op in ("decode", "rebuild"):
            plan = self.decode_plan  # pin ONE pattern for slice + queue
            v = np.asarray(payload)
            if v.shape[0] != self.spec.N and (op == "rebuild"
                                              or v.shape[0] != self.spec.K):
                raise ValueError(
                    f"{op} payload must carry the full N={self.spec.N} "
                    "codeword rows"
                    + ("" if op == "rebuild"
                       else f" (or the K={self.spec.K} kept survivor rows)")
                    + f", got leading dim {v.shape[0]}")
            queue = self._ensure_queue()
            submit = (queue.submit_decode if op == "decode"
                      else queue.submit_rebuild)
            return submit(self.spec, plan.erased, v, A=self._A,
                          pattern_ref=self._live_pattern, meta=meta)
        raise ValueError(
            f"op must be 'encode', 'decode' or 'rebuild', got {op!r}")

    def _live_pattern(self) -> tuple[int, ...]:
        """The CURRENT erasure pattern — handed to queued decode/rebuild
        requests so the worker can detect a pinned pattern invalidated by
        a later `fail()` and replan against the superset."""
        return self.failed

    def submit_encode(self, x):
        return self.submit("encode", x)

    def submit_decode(self, v):
        return self.submit("decode", v)

    def submit_rebuild(self, v):
        return self.submit("rebuild", v)

    # -- lifecycle / introspection ------------------------------------------
    def close(self) -> None:
        """Drain and stop the session's OWN coding queue (no-op if never
        started; a shared queue handed in at construction is left
        running), then uninstall the session's tracer (saving it when
        `trace=` was a path).  The session stays usable — a later `submit`
        lazily opens a fresh queue."""
        with self._lock:
            queue, self._queue = self._queue, None
        if queue is not None:
            queue.close()
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

    def stats(self) -> dict:
        """One coherent snapshot: erasure state, per-plan model costs and
        this thread's last measured run stats, queue coalescing counters,
        and the shared cache statistics."""
        enc = self._enc
        out: dict = {
            "spec": self.spec,
            "backend": self.backend,
            "failed": self.failed,
            "encode": {
                "method": enc.method,
                "cost": enc.cost(),
                "model_us": self.link.us(enc.cost()),
                "last": enc.last_stats,
            },
        }
        tc = enc.tiered_cost()
        if tc is not None or self._placement is not None:
            tiers: dict = {"placement": self._placement.policy
                           if self._placement else None}
            if tc is not None:
                tiers["model"] = {"intra": tc.intra, "inter": tc.inter}
                tiers["model_us"] = self.link.us(tc)
            net = enc.sim_net
            if net is not None and getattr(net, "placement", None) is not None:
                tiers["measured"] = net.by_tier()
            out["encode"]["tiers"] = tiers
        if self.failed:
            from ..recover import UndecodableError

            try:
                plan = self.decode_plan
            except UndecodableError as exc:
                # introspection must not crash on an information-losing
                # pattern (possible for the non-MDS dft codeword)
                out["decode"] = {"decodable": False, "erased": self.failed,
                                 "error": str(exc)}
            else:
                out["decode"] = {
                    "decodable": True,
                    "erased": plan.erased,
                    "kept": plan.kept,
                    "cost": plan.cost(),
                    "model_us": self.link.us(plan.cost()),
                    "last": plan.last_stats,
                }
        with self._lock:
            q = self._shared_queue or self._queue
            if q is not None:
                # snapshot, not the live object: the worker thread keeps
                # mutating QueueStats after this call returns
                from ..launch.coding_queue import QueueStats

                live = q.stats
                out["queue"] = QueueStats(live.requests, live.batches,
                                          list(live.coalesced),
                                          live.failovers)
        from . import cache_info

        out["cache"] = cache_info()
        from ..obs.drift import LEDGER
        from ..obs.metrics import REGISTRY

        out["metrics"] = REGISTRY.snapshot()
        if get_backend(self.backend).measures_network:
            out["drift"] = LEDGER.snapshot()
        return out

    def describe(self) -> str:
        s = self.spec
        be = get_backend(self.backend)
        lines = [
            f"CodedSystem[{s.kind}] K={s.K} R={s.R} p={s.p} W={s.W} "
            f"q={s.q} backend={self.backend}",
            f"  failed  : {list(self.failed) or 'none'}",
            f"  caps    : stream={'device-pipelined' if be.supports_stream else 'per-chunk'}, "
            f"network-measuring={be.measures_network}",
        ]
        from ..topo import TieredLinkModel

        if isinstance(self.link, TieredLinkModel):
            lines.append(
                f"  link    : intra a={self.link.alpha_intra:g} "
                f"b={self.link.beta_bits_intra:g} | inter "
                f"a={self.link.alpha_inter:g} "
                f"b={self.link.beta_bits_inter:g}")
        lines += ["  " + ln for ln in self._enc.describe().splitlines()]
        if self.failed:
            from ..recover import UndecodableError

            try:
                dlines = self.decode_plan.describe().splitlines()
            except UndecodableError:
                dlines = [f"decode  : UNDECODABLE — erased "
                          f"{list(self.failed)} is information-losing for "
                          f"this (non-MDS) code"]
            lines += ["  " + ln for ln in dlines]
        if be.measures_network:
            from ..obs.drift import LEDGER

            lines += ["  " + ln for ln in LEDGER.describe().splitlines()]
        return "\n".join(lines)
