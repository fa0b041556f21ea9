"""CodedService: a multi-tenant serving layer over pooled CodedSystems.

One process serving coded storage in production fronts *many* tenants,
each driving *many* volumes — the regime of Dimakis et al.'s decentralized
erasure codes (many sources feeding many storage nodes concurrently).
`CodedService` is that layer: it owns

  * a **session pool** — `CodedSystem` sessions keyed by
    (tenant, spec, backend, A-digest), created on first use, LRU-evicted
    beyond `max_sessions` (only sessions with nothing in flight and no
    live erasure state are evictable — erasure state is truth, not cache);
  * **one shared `CodingQueue`** — every pooled session submits through
    it, so requests that share an executable plan — same (spec, backend,
    A-digest) — coalesce into ONE `run_batched` execution *across
    sessions and tenants* while each future still resolves to its own
    rows;
  * an **admission gate** (`launch.tenancy.AdmissionController`) — global
    and per-tenant ceilings on in-flight ops/bytes with weighted-fair
    scheduling of waiters.  `submit()` blocks under backpressure (bounded,
    optional timeout) or raises `QueueFullError` with ``block=False``;
    nothing is ever silently dropped;
  * **per-tenant / per-tag observability** — `ServiceStats` (queue depth,
    coalescing ratio, p50/p99/p999 latency, failover counts) surfaced
    through `stats()` / `describe()`.

The shared queue and every pooled session run on the service's `device`
(None means "cuda"; a missing card raises RuntimeError; moot on the
host-only simulator).

Quickstart::

    from repro_torch.api import CodeSpec
    from repro_torch.launch import CodedService

    svc = CodedService(backend="local", max_inflight_ops=512)
    spec = CodeSpec(kind="rs", K=16, R=4)
    fut = svc.submit("tenant-a", spec, "encode", x)     # coalesces with
    fut2 = svc.submit("tenant-b", spec, "encode", x2)   # tenant-b's ops
    parity = fut.result()
    svc.session("tenant-a", spec).fail([2])             # erasure state is
    rep = svc.submit("tenant-a", spec, "decode", cw)    # per-session
    print(svc.describe())
    svc.close()

Failure semantics are the session's: decode/rebuild submissions pin the
session's erasure pattern at submit time and fail over to a superset
pattern if more processors die in the queue (`CodingQueue` failover); a
future resolves bitwise-correct or raises — `close()` drains everything
accepted and accounts for every admitted slot even on a timed-out drain.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ..api.planner import _digest
from ..api.registry import plan_device
from ..api.spec import CodeSpec
from ..api.system import CodedSystem
from ..obs import trace as _trace
from ..obs.metrics import REGISTRY as _METRICS
from .coding_queue import CodingQueue
from .tenancy import (
    AdmissionController,
    QueueFullError,
    ServiceStats,
    TenantQuota,
)

__all__ = ["CodedService", "QueueFullError", "ServiceStats", "TenantQuota"]

_OPS = ("encode", "decode", "rebuild")

_SVC_OPS = _METRICS.counter("service_ops_total",
                            "tenant operations settled by the service")
_SVC_REJECTED = _METRICS.counter("service_rejected_total",
                                 "submissions refused at admission")
_SVC_LAT = _METRICS.histogram("service_latency_us",
                              "submit-to-settle latency per tenant op")


@dataclass
class _OpMeta:
    """Per-operation tag threaded through the queue and the future's done
    callback — carries everything needed to settle admission and stats."""

    tenant: str
    key: tuple
    tag: str | None
    nbytes: int
    t0: float
    op: str = "?"
    t_trace: float = 0.0   # tracer timestamp at submit (0 = untraced)


class CodedService:
    """Multi-tenant serving front-end (see module docstring).

    Parameters
    ----------
    backend           : registered backend every pooled session runs on
    device            : torch device of the shared queue and of every
                        pooled session (None means "cuda")
    max_inflight_ops  : global cap on admitted-but-unresolved operations
    max_inflight_bytes: global cap on admitted payload bytes in flight
    default_quota     : `TenantQuota` for tenants without an explicit one
    max_sessions      : session-pool size before idle LRU eviction
    chunk_w/max_batch_w : forwarded to the shared `CodingQueue`
    trace             : observability tracer — True (collect, read
                        `svc.tracer`), an `obs.trace.Tracer`, or a path
                        (trace JSON written there on `close()`).  The
                        tracer is process-installed for the service's
                        lifetime, so every layer underneath (queue,
                        stream pipeline, simulator rounds, kernels)
                        emits onto the same timeline.
    """

    def __init__(self, backend: str = "local", *, device=None,
                 max_inflight_ops: int = 1024,
                 max_inflight_bytes: int = 1 << 31,
                 default_quota: TenantQuota | None = None,
                 max_sessions: int = 64,
                 chunk_w: int | None = None,
                 max_batch_w: int = 1 << 16,
                 trace=None):
        self.backend = backend
        self.device = plan_device(backend, device)
        self.tracer, self._trace_path = _trace.resolve(trace)
        if self.tracer is not None:
            _trace.install(self.tracer)
        self._admission = AdmissionController(
            max_ops=max_inflight_ops, max_bytes=max_inflight_bytes,
            default_quota=default_quota)
        self._queue = CodingQueue(backend=backend, chunk_w=chunk_w,
                                  max_batch_w=max_batch_w,
                                  observer=self._observe, device=self.device)
        self._sessions: OrderedDict[tuple, CodedSystem] = OrderedDict()
        self._session_inflight: dict[tuple, int] = {}
        self._tenants: dict[str, ServiceStats] = {}
        self._tags: dict[str, ServiceStats] = {}
        self.max_sessions = max_sessions
        self._lock = threading.RLock()
        self._closed = False

    # -- quotas / stats registries ------------------------------------------
    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        """Install (or replace) `tenant`'s admission quota; waiters are
        re-evaluated immediately, so raising a quota unblocks live load."""
        self._admission.set_quota(tenant, quota)

    def _tenant_stats(self, tenant: str) -> ServiceStats:
        with self._lock:
            st = self._tenants.get(tenant)
            if st is None:
                st = self._tenants[tenant] = ServiceStats(tenant)
            return st

    def _tag_stats(self, tag: str) -> ServiceStats:
        with self._lock:
            st = self._tags.get(tag)
            if st is None:
                st = self._tags[tag] = ServiceStats(tag)
            return st

    # -- session pool --------------------------------------------------------
    def _key(self, tenant: str, spec: CodeSpec, A) -> tuple:
        return (tenant, spec, self.backend, _digest(A))

    def session(self, tenant: str, spec: CodeSpec, *,
                A: np.ndarray | None = None) -> CodedSystem:
        """The pooled `CodedSystem` for (tenant, spec, A) — created on
        first use, shared across that tenant's submissions, carrying the
        volume's live erasure state (`.fail()`/`.heal()` on it steer every
        later decode/rebuild the service routes there)."""
        key = self._key(tenant, spec, A)
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
            sess = self._sessions.get(key)
            if sess is not None:
                self._sessions.move_to_end(key)
                return sess
            sess = CodedSystem(spec, backend=self.backend, A=A,
                               queue=self._queue, device=self.device)
            self._sessions[key] = sess
            self._evict_idle()
            return sess

    def _evict_idle(self) -> None:
        """Drop least-recently-used sessions beyond `max_sessions` (must
        hold the lock).  Only sessions with zero in-flight ops AND no live
        failures are evictable: erasure state is system truth — evicting
        it would silently 'heal' a degraded volume."""
        if len(self._sessions) <= self.max_sessions:
            return
        for key in list(self._sessions):
            if len(self._sessions) <= self.max_sessions:
                return
            if self._session_inflight.get(key, 0) == 0 \
                    and not self._sessions[key].failed:
                # close() is pool-safe: the shared queue is not the
                # session's to stop
                self._sessions.pop(key).close()

    @property
    def sessions(self) -> int:
        with self._lock:
            return len(self._sessions)

    # -- submission ----------------------------------------------------------
    def submit(self, tenant: str, spec: CodeSpec, op: str, payload, *,
               A: np.ndarray | None = None, tag: str | None = None,
               block: bool = True, timeout: float | None = None):
        """Admission-controlled async submission; returns a
        `concurrent.futures.Future`.

        The op first passes the admission gate (blocking under bounded
        backpressure, or raising `QueueFullError` when ``block=False`` /
        on `timeout`), then rides the pooled session's queue path —
        coalescing with every other in-flight request that shares its
        (spec, backend, A-digest) plan, from ANY session or tenant.  `tag`
        additionally aggregates stats under `stats()["tags"]` (e.g. one
        tag per volume).  The future resolves to the op's own rows
        (encode -> parity, decode -> pinned-pattern rows, rebuild ->
        healed codeword) or raises; admission is released exactly when the
        future settles, so in-flight gauges include queue residency.
        """
        if op not in _OPS:
            raise ValueError(f"op must be one of {_OPS}, got {op!r}")
        stats = self._tenant_stats(tenant)
        v = np.asarray(payload)
        nbytes = int(v.nbytes)
        tracer = _trace.get_tracer()
        try:
            # the admit span makes backpressure *visible*: a long one is
            # time spent blocked on quota, not compute
            with _trace.host_span("admit", "service", tid=tenant,
                                  cat="service.admit", op=op, nbytes=nbytes):
                self._admission.acquire(tenant, nbytes, block=block,
                                        timeout=timeout)
        except QueueFullError:
            stats.record_rejected()
            _SVC_REJECTED.inc(1, tenant=tenant, op=op)
            if tag is not None:
                self._tag_stats(tag).record_rejected()
            raise
        try:
            sess = self.session(tenant, spec, A=A)
            meta = _OpMeta(tenant, self._key(tenant, spec, A), tag, nbytes,
                           time.perf_counter(), op=op,
                           t_trace=(tracer.now_us() if tracer is not None
                                    else 0.0))
            with self._lock:
                self._session_inflight[meta.key] = \
                    self._session_inflight.get(meta.key, 0) + 1
            stats.record_submitted(nbytes)
            if tag is not None:
                self._tag_stats(tag).record_submitted(nbytes)
            try:
                fut = sess.submit(op, v, meta=meta)
            except BaseException:
                self._settle(meta, ok=False, record_done=True)
                raise
        except BaseException:
            # admission slot must not leak when the submission never
            # reached the queue (closed queue, bad payload shape, ...)
            self._admission.release(tenant, nbytes)
            raise
        fut.add_done_callback(lambda f, m=meta: self._on_done(m, f))
        return fut

    # -- settlement ----------------------------------------------------------
    def _settle(self, meta: _OpMeta, *, ok: bool,
                record_done: bool) -> None:
        lat_us = (time.perf_counter() - meta.t0) * 1e6
        with self._lock:
            left = self._session_inflight.get(meta.key, 1) - 1
            if left:
                self._session_inflight[meta.key] = left
            else:
                self._session_inflight.pop(meta.key, None)
        if record_done:
            self._tenant_stats(meta.tenant).record_done(lat_us, meta.nbytes,
                                                        ok)
            if meta.tag is not None:
                self._tag_stats(meta.tag).record_done(lat_us, meta.nbytes,
                                                      ok)
            _SVC_OPS.inc(1, tenant=meta.tenant, op=meta.op,
                         status="ok" if ok else "error")
            _SVC_LAT.observe(lat_us, tenant=meta.tenant, op=meta.op)
            if meta.t_trace:
                tracer = _trace.get_tracer()
                if tracer is not None:
                    # per-tenant op-lifetime span: submit -> settle (queue
                    # residency + execution + callback), tagged for the
                    # viewer's detail pane
                    tracer.complete(
                        f"op.{meta.op}", meta.t_trace,
                        tracer.now_us() - meta.t_trace, pid="service",
                        tid=meta.tenant, cat="service.op",
                        args={"tenant": meta.tenant, "tag": meta.tag,
                              "nbytes": meta.nbytes, "ok": ok})

    def _on_done(self, meta: _OpMeta, fut) -> None:
        ok = not fut.cancelled() and fut.exception() is None
        self._settle(meta, ok=ok, record_done=True)
        self._admission.release(meta.tenant, meta.nbytes)

    def _observe(self, meta: _OpMeta, op: str, group_n: int,
                 failover: bool) -> None:
        """CodingQueue observer: per-op coalescing/failover attribution
        (runs on the queue worker as each request resolves)."""
        self._tenant_stats(meta.tenant).record_executed(group_n, failover)
        if meta.tag is not None:
            self._tag_stats(meta.tag).record_executed(group_n, failover)

    # -- introspection / lifecycle -------------------------------------------
    def stats(self) -> dict:
        """{"service": {...}, "tenants": {name: snapshot},
        "tags": {name: snapshot}} — service-level numbers are pool-wide
        (shared-queue coalescing ratio counts every session's requests)."""
        with self._lock:
            tenants = {k: v.snapshot() for k, v in self._tenants.items()}
            tags = {k: v.snapshot() for k, v in self._tags.items()}
            n_sessions = len(self._sessions)
        qs = self._queue.stats
        ops, nbytes = self._admission.inflight()
        return {
            "service": {
                "backend": self.backend,
                "device": str(self.device),
                "sessions": n_sessions,
                "queue_depth": self._queue.depth,
                "inflight_ops": ops,
                "inflight_bytes": nbytes,
                "waiting": self._admission.waiting,
                "requests": qs.requests,
                "batches": qs.batches,
                "coalescing_ratio": (qs.requests / qs.batches
                                     if qs.batches else float("nan")),
                "failovers": qs.failovers,
            },
            "tenants": tenants,
            "tags": tags,
            "metrics": _METRICS.snapshot(),
        }

    def latencies_us(self, tenant: str | None = None) -> list[float]:
        """The raw completion-latency reservoir — one tenant's, or every
        tenant's merged (for aggregate percentiles in benches)."""
        with self._lock:
            stats = ([self._tenants[tenant]] if tenant is not None
                     else list(self._tenants.values()))
        out: list[float] = []
        for s in stats:
            out.extend(s.latencies_us())
        return out

    @property
    def queue_depth(self) -> int:
        """Requests accepted by the shared queue but not yet resolved."""
        return self._queue.depth

    def describe(self) -> str:
        st = self.stats()
        s = st["service"]
        lines = [
            f"CodedService backend={s['backend']} device={s['device']} "
            f"sessions={s['sessions']} "
            f"queue_depth={s['queue_depth']} inflight={s['inflight_ops']} ops"
            f"/{s['inflight_bytes']} B waiting={s['waiting']}",
            f"  queue   : {s['requests']} requests in {s['batches']} batches "
            f"(coalescing {s['coalescing_ratio']:.2f}x, "
            f"{s['failovers']} failover(s))",
        ]
        for kind in ("tenants", "tags"):
            for name, t in sorted(st[kind].items()):
                lines.append(
                    f"  {kind[:-1]:7s}: {name}: {t['submitted']} submitted / "
                    f"{t['completed']} ok / {t['failed']} failed / "
                    f"{t['rejected']} rejected; inflight={t['inflight_ops']}; "
                    f"coalesce={t['coalescing_ratio']:.2f}x "
                    f"failovers={t['failovers']}; "
                    f"p50={t['p50_us']:.0f}us p99={t['p99_us']:.0f}us "
                    f"p999={t['p999_us']:.0f}us")
        return "\n".join(lines)

    def close(self, timeout: float | None = 30.0) -> None:
        """Drain the shared queue (every accepted future resolves or is
        failed loudly), close every pooled session, and refuse further
        submissions.  Admission slots settle through the futures' done
        callbacks — even a timed-out drain fails the stranded futures,
        which releases their slots."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            sessions = list(self._sessions.values())
            self._sessions.clear()
        try:
            self._queue.close(timeout=timeout)
        finally:
            for sess in sessions:
                sess.close()
            if self.tracer is not None:
                _trace.uninstall(self.tracer)
                if self._trace_path is not None:
                    self.tracer.save(self._trace_path)

    def __enter__(self) -> "CodedService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
