"""Batched request queue: coalesce concurrent encode/decode/rebuild
requests into streamed plan executions.

A serving replica receives many small independent coding requests (encode
these shards, repair that erasure pattern, re-materialize that codeword).
Dispatching each one as its own `plan.run` pays kernel launches and
transfer overhead per request; the queue instead drains whatever is
pending, groups requests that share an executable plan — same (spec,
method/erasure pattern, backend, device) — and runs each group as ONE
`plan.run_batched` call, so concurrent payloads ride the same device
pipeline (api/stream.py).

    q = CodingQueue(backend="local")        # device="cuda" by default
    fut = q.submit_encode(spec, x)          # returns concurrent Future
    y = fut.result()
    q.close()

Every plan of the queue is made on its `device` (None means "cuda", as
everywhere in the port; moot on the host-only simulator).  On a CUDA
device the worker thread launches on a stream of its own, so queued work
never serializes behind the submitting threads' default-stream work.

This is the engine behind `repro_torch.api.CodedSystem.submit` — a session lazily
opens one queue on its backend and routes `submit("encode"|"decode"|
"rebuild", ...)` futures through it; direct `CodingQueue` use remains
supported for callers batching across specs.

Erasure patterns are pinned per request at submit time, with *failover*:
a request submitted with `pattern_ref` (a callable returning the live
pattern — sessions pass theirs) is re-checked when the worker drains it.
If the live pattern has grown into a strict superset of the pinned one —
processors died while the request sat in the queue — the request is
transparently replanned against the superset and its (N, W) payload
re-sliced to the new survivor set, so symbols from dead processors are
never consumed; a decode future still resolves to the rows of its pinned
pattern, a rebuild future to the fully healed codeword.  A (K, W)
survivors-only decode payload cannot be re-sliced: its future fails with a
`RuntimeError` instead of silently decoding stale rows.

Single worker thread; batching is opportunistic (whatever accumulated
since the last drain, bounded by `max_batch_w` payload columns per group).
Correctness is backend-bitwise: results equal per-request `plan.run`.
`close()` drains everything accepted; if the worker fails to drain within
the timeout, every still-pending Future is failed with a `RuntimeError`
and the timeout is raised — accepted futures never dangle unresolved.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable

import numpy as np

from ..obs.metrics import REGISTRY as _METRICS
from ..obs.trace import get_tracer, host_span

_Q_REQS = _METRICS.counter("queue_requests_total",
                           "requests drained by the coding queue")
_Q_BATCHES = _METRICS.counter("queue_batches_total",
                              "coalesced plan-group executions")
_Q_FAILOVERS = _METRICS.counter(
    "queue_failovers_total", "requests replanned onto a superset pattern")
_Q_GROUP = _METRICS.histogram("queue_group_size",
                              "requests coalesced per group execution")


@dataclass
class _Request:
    op: str                    # "encode" | "decode" | "rebuild"
    spec: Any
    erased: tuple | None       # pinned erasure pattern (decode/rebuild)
    A: Any                     # explicit generator block (or None)
    payload: np.ndarray
    future: Future
    digest: str | None = None  # A digest (part of the group key)
    pattern_ref: Callable | None = None  # live-pattern getter (failover)
    effective: tuple | None = None       # pattern resolved at drain time
    meta: Any = None           # opaque caller tag, echoed to the observer
    group_n: int = 1           # size of the coalesced group it executed in
    t_submit: float = 0.0      # tracer timestamp at submit (0 = untraced)


@dataclass
class QueueStats:
    requests: int = 0
    batches: int = 0
    coalesced: list[int] = dc_field(default_factory=list)  # group sizes
    failovers: int = 0         # requests replanned onto a superset pattern

    @property
    def max_coalesced(self) -> int:
        return max(self.coalesced, default=0)


class CodingQueue:
    """Coalescing encode/decode/rebuild front-end over the plan caches."""

    def __init__(self, backend: str = "local", *,
                 chunk_w: int | None = None, max_batch_w: int = 1 << 16,
                 observer: Callable | None = None, device=None):
        # finish torch's first import on THIS thread: letting the worker
        # and concurrent clients race a first import can observe a
        # partially initialized module
        import torch

        from ..api.registry import plan_device

        self.backend = backend
        self.device = plan_device(backend, device)
        # the worker's own stream, made here so a CUDA fault raises to the
        # caller instead of killing the worker
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device is not None
                        and self.device.type == "cuda" else None)
        self.chunk_w = chunk_w
        self.max_batch_w = max_batch_w
        # observer(meta, op, group_n, failover) is called on the worker
        # thread as each request resolves (only for requests submitted
        # with a meta tag) — the service layer's per-tenant observability
        # hook; observer exceptions are swallowed, never fail a future
        self.observer = observer
        self.stats = QueueStats()
        self._q: "queue.Queue[_Request | None]" = queue.Queue()
        self._closing = False
        self._pending: set[Future] = set()
        self._plock = threading.Lock()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    # -- client side --------------------------------------------------------
    def submit_encode(self, spec, x, A=None, meta=None) -> Future:
        """Encode payload x (K,)/(K, W) under `spec`; Future of sinks.
        `A` is the explicit generator block for kind="universal"/"lagrange"
        specs that carry one (same contract as `Encoder.plan`); its digest
        is part of the group key, so same-spec requests with different
        matrices never coalesce into one plan."""
        from ..api.planner import _digest

        return self._submit(_Request("encode", spec, None, A, np.asarray(x),
                                     Future(), digest=_digest(A), meta=meta))

    def submit_decode(self, spec, erased, v, A=None,
                      pattern_ref=None, meta=None) -> Future:
        """Repair `erased` from v; Future of the erased symbols (rows
        ordered like the pinned pattern).  `v` carries either the K kept
        survivor rows (classic) or the full (N, W) codeword — the worker
        slices it; the full form is required for failover (`pattern_ref`,
        see module docstring)."""
        from ..api.planner import _digest

        erased = tuple(sorted({int(e) for e in erased}))
        return self._submit(_Request("decode", spec, erased, A,
                                     np.asarray(v), Future(),
                                     digest=_digest(A),
                                     pattern_ref=pattern_ref, meta=meta))

    def submit_rebuild(self, spec, erased, cw, A=None,
                       pattern_ref=None, meta=None) -> Future:
        """Re-materialize the full codeword: Future of the healed (N, W)
        with every position of the (possibly failed-over) pattern
        recomputed.  `cw` must carry the full N codeword rows."""
        from ..api.planner import _digest

        erased = tuple(sorted({int(e) for e in erased}))
        cw = np.asarray(cw)
        if cw.shape[0] != spec.N:
            raise ValueError(
                f"rebuild payload must carry the full N={spec.N} codeword "
                f"rows, got leading dim {cw.shape[0]}")
        return self._submit(_Request("rebuild", spec, erased, A, cw,
                                     Future(), digest=_digest(A),
                                     pattern_ref=pattern_ref, meta=meta))

    def _submit(self, req: _Request) -> Future:
        # the closed check, pending registration and enqueue are ONE
        # critical section with close()'s sentinel put: a submit serialized
        # before close lands ahead of the sentinel (the worker drains it),
        # a submit serialized after raises — a late request can never slip
        # in behind the worker's final drain and hang its future
        tracer = get_tracer()
        if tracer is not None:
            req.t_submit = tracer.now_us()
        with self._plock:
            if self._closing or self._worker is None:
                raise RuntimeError("queue is closed")
            self._pending.add(req.future)
            self._q.put(req)
        return req.future

    @property
    def depth(self) -> int:
        """Requests accepted but not yet resolved (queued or executing)."""
        with self._plock:
            return len(self._pending)

    def close(self, timeout: float | None = 30.0) -> None:
        """Drain outstanding requests and stop the worker.

        The worker processes everything still queued before exiting, so no
        accepted Future is left unresolved; the submit/close boundary is
        locked, so a submit racing with close either lands ahead of the
        shutdown sentinel (and resolves) or deterministically raises
        ``RuntimeError("queue is closed")``.  If the worker does NOT drain
        within `timeout`, every still-pending Future is failed with a
        `RuntimeError` and the same error is raised here — a timed-out
        close is loud, never a silent return with live futures dangling.
        """
        with self._plock:
            worker = self._worker
            if worker is None:
                return
            if not self._closing:
                self._closing = True
                self._q.put(None)
        worker.join(timeout=timeout)
        if worker.is_alive():
            with self._plock:
                stranded = [f for f in self._pending if not f.done()]
                self._pending.clear()
            err = RuntimeError(
                f"CodingQueue.close(): worker did not drain within "
                f"{timeout}s; {len(stranded)} pending request(s) failed")
            for fut in stranded:
                if not fut.done():
                    fut.set_exception(err)
            raise err
        self._worker = None

    # -- worker side --------------------------------------------------------
    def _drain(self, first: _Request | None) -> tuple[list[_Request], bool]:
        """Everything currently queued, and whether a close() sentinel was
        seen (leftovers BEHIND the sentinel are drained too — they raced
        with close() and must still resolve)."""
        batch = [] if first is None else [first]
        closing = first is None
        while True:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                return batch, closing
            if nxt is None:
                closing = True
            else:
                batch.append(nxt)

    def _resolve(self, req: _Request, *, result=None, exc=None) -> None:
        if req.t_submit:
            tracer = get_tracer()
            if tracer is not None:
                # one span per request: submit -> (coalesce+execute) ->
                # resolve, on the queue's per-op track
                tracer.complete(
                    f"op.{req.op}", req.t_submit,
                    tracer.now_us() - req.t_submit, pid="queue",
                    tid=req.op, cat="queue.op",
                    args={"group_n": req.group_n,
                          "kind": req.spec.kind, "K": req.spec.K,
                          "ok": exc is None,
                          "failover": bool(req.op != "encode"
                                           and req.effective is not None
                                           and req.effective != req.erased)})
        if self.observer is not None and req.meta is not None:
            # BEFORE the future resolves: a client unblocked by result()
            # must already see this op in the observer-fed stats
            failover = (req.op != "encode" and req.effective is not None
                        and req.effective != req.erased)
            try:
                self.observer(req.meta, req.op, req.group_n, failover)
            except Exception:  # noqa: BLE001 — observability never fails ops
                pass
        if not req.future.done():
            if exc is not None:
                req.future.set_exception(exc)
            else:
                req.future.set_result(result)
        with self._plock:
            self._pending.discard(req.future)

    def _effective_pattern(self, req: _Request) -> tuple:
        """The pattern this request will execute against, resolved at
        drain time: the pinned pattern, unless `pattern_ref` reports a
        strict superset (new failures landed since submit) — then the
        superset, so the plan never consumes dead survivors."""
        if req.op == "encode" or req.pattern_ref is None:
            return req.erased or ()
        live = tuple(sorted({int(e) for e in req.pattern_ref()}))
        if set(live) > set(req.erased):
            self.stats.failovers += 1
            _Q_FAILOVERS.inc(1, backend=self.backend)
            return live
        return req.erased

    def _group_key(self, req: _Request) -> tuple:
        if req.op == "encode":
            return ("enc", req.spec, self.backend, req.digest)
        # decode and rebuild share the plan (same pattern => same repair
        # matrix) but not the output contract — keep the op in the key
        return (req.op, req.spec, req.effective, self.backend, req.digest)

    def _loop(self) -> None:
        if self._stream is None:
            self._serve()
            return
        import torch

        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            self._serve()

    def _serve(self) -> None:
        while True:
            first = self._q.get()
            batch, closing = self._drain(first)
            self.stats.requests += len(batch)  # single-writer: the worker
            if batch:
                _Q_REQS.inc(len(batch), backend=self.backend)
            groups: dict[tuple, list[_Request]] = {}
            for req in batch:
                req.effective = self._effective_pattern(req)
                groups.setdefault(self._group_key(req), []).append(req)
            for reqs in groups.values():
                self._process_group(reqs)
            if closing:
                return

    def _slice(self, req: _Request, plan) -> np.ndarray:
        """The (K, ...) survivor view `plan` consumes, re-sliced against
        the EFFECTIVE pattern (failover may have changed plan.kept)."""
        if req.op == "encode":
            return req.payload
        p = req.payload
        if p.shape[0] == req.spec.N:
            return p[list(plan.kept)]
        if p.shape[0] == req.spec.K:
            if req.effective != req.erased:
                raise RuntimeError(
                    f"pattern invalidated mid-flight ({req.erased} -> "
                    f"{req.effective}) but the request carried only the K "
                    "kept survivor rows — resubmit with the full (N, W) "
                    "codeword so the repair can re-slice around the new "
                    "failures")
            return p
        raise ValueError(
            f"payload must carry N={req.spec.N} or K={req.spec.K} rows, "
            f"got {p.shape}")

    def _postprocess(self, req: _Request, plan, out: np.ndarray) -> np.ndarray:
        """Shape the group-plan output into the request's contract."""
        if req.op == "decode":
            if req.effective != req.erased:
                # failover: the plan repaired the superset; the future
                # still resolves to the rows of the pinned pattern
                idx = [plan.erased.index(e) for e in req.erased]
                out = out[idx]
            return out
        if req.op == "rebuild":
            from ..api.backends import host_layout

            return host_layout(req.spec.N, req.spec.q, req.payload, rows=out,
                               rows_at=plan.erased)
        return out

    def _process_group(self, reqs: list[_Request]) -> None:
        self.stats.batches += 1
        self.stats.coalesced.append(len(reqs))
        _Q_BATCHES.inc(1, backend=self.backend, op=reqs[0].op)
        _Q_GROUP.observe(len(reqs), backend=self.backend, op=reqs[0].op)
        for req in reqs:
            req.group_n = len(reqs)
        r0 = reqs[0]
        with host_span(f"execute.{r0.op}", "queue", tid="worker",
                       cat="queue.exec", group_n=len(reqs),
                       kind=r0.spec.kind, K=r0.spec.K, R=r0.spec.R):
            self._execute_group(reqs)

    def _execute_group(self, reqs: list[_Request]) -> None:
        from ..api import Encoder
        from ..recover import Decoder

        try:
            r0 = reqs[0]
            if r0.op == "encode":
                plan = Encoder.plan(r0.spec, backend=self.backend, A=r0.A,
                                    device=self.device)
            else:
                plan = Decoder.plan(r0.spec, erased=r0.effective,
                                    backend=self.backend, A=r0.A,
                                    device=self.device)
            # per-request slicing failures (stale K-row payloads) fail
            # their own future without sinking the rest of the group
            runnable: list[tuple[_Request, np.ndarray]] = []
            for req in reqs:
                try:
                    runnable.append((req, self._slice(req, plan)))
                except Exception as exc:  # noqa: BLE001 — per-future
                    self._resolve(req, exc=exc)
            # bound the coalesced width per run_batched call
            chunk: list[tuple[_Request, np.ndarray]] = []
            w = 0
            for req, v in runnable:
                rw = 1 if v.ndim == 1 else v.shape[1]
                if chunk and w + rw > self.max_batch_w:
                    self._run_group(plan, chunk)
                    chunk, w = [], 0
                chunk.append((req, v))
                w += rw
            if chunk:
                self._run_group(plan, chunk)
        except Exception as exc:  # noqa: BLE001 — propagate per-future
            for req in reqs:
                self._resolve(req, exc=exc)

    def _run_group(self, plan,
                   reqs: list[tuple[_Request, np.ndarray]]) -> None:
        outs = plan.run_batched([v for _, v in reqs], chunk_w=self.chunk_w)
        for (req, _), out in zip(reqs, outs):
            self._resolve(req, result=self._postprocess(req, plan, out))
